"""The YOLOv2 output layer and its host helpers (PyTorch port of
``nn/layers/objdetect.py``; Yolo2OutputLayer.java and YoloUtils): the loss
over the NHWC [B, H, W, A * (5 + C)] prediction grid, the decoded grid
(``activate``), and the numpy box utilities (IOU, decoding to
:class:`DetectedObject`, class-wise non-max suppression), which run on the
host.

Labels: [B, H, W, 4 + C] per grid cell, (x1, y1, x2, y2) in grid units and
a one-hot class; cells without an object are all zero.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.config import LayerConfig, register_layer
from deeplearning4j_tpu_torch.nn.input_type import InputType

__all__ = ["DetectedObject", "Yolo2OutputLayer", "get_predicted_objects", "iou_xyxy",
           "non_max_suppression"]


@register_layer("yolo2_output")
@dataclass
class Yolo2OutputLayer(LayerConfig):
    """The YOLOv2 loss head. ``boxes``: anchor priors [(w, h), ...] in grid
    units; ``lambda_coord`` and ``lambda_no_obj`` default to the
    reference's 5.0 and 0.5."""

    CONSUMES_CONV = True  # takes [b, h, w, c] as it is (no flattening)

    boxes: Tuple[Tuple[float, float], ...] = ((1.0, 1.0),)
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    @property
    def n_anchors(self) -> int:
        return len(self.boxes)

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x, state  # the raw grid; activate() decodes it

    def _split_grid(self, x, n_classes):
        """[B, H, W, A * (5 + C)] -> (xy, wh, conf, class logits)."""
        B, H, W, _ = x.shape
        g = x.reshape(B, H, W, self.n_anchors, 5 + n_classes)
        return g[..., 0:2], g[..., 2:4], g[..., 4], g[..., 5:]

    def activate(self, x, n_classes):
        """The network output as an interpretable grid: sigmoid xy offsets,
        anchor-scaled wh, sigmoid objectness, softmax class probabilities
        (YoloUtils.activate)."""
        xy, wh, conf, cls = self._split_grid(x, n_classes)
        anchors = torch.as_tensor(self.boxes, dtype=x.dtype, device=x.device)   # [A, 2]
        return (torch.sigmoid(xy), torch.exp(wh) * anchors, torch.sigmoid(conf),
                torch.softmax(cls, dim=-1))

    def score(self, params, x, labels, mask=None, average=True, weights=None):
        """The YOLOv2 loss (Yolo2OutputLayer.computeScore): coordinates (xy
        and sqrt wh) on the responsible anchors, objectness toward the TRUE
        IOU of the decoded box with the ground truth on positives and toward
        0 elsewhere, class cross-entropy on object cells. The responsible
        anchor is the prior of best shape-IOU with the ground truth."""
        n_classes = labels.shape[-1] - 4
        B, H, W, _ = labels.shape
        A = self.n_anchors
        dt, dev = x.dtype, x.device
        labels = labels.to(dt)

        gt_box = labels[..., :4]                                 # [B, H, W, 4]
        gt_cls = labels[..., 4:]                                 # [B, H, W, C]
        obj = (torch.sum(gt_cls, dim=-1) > 0).to(dt)             # [B, H, W]
        pxy, pwh, pconf, pcls = self.activate(x, n_classes)

        gt_cxy = (gt_box[..., 0:2] + gt_box[..., 2:4]) / 2.0
        gt_wh = torch.clamp_min(gt_box[..., 2:4] - gt_box[..., 0:2], 1e-6)
        gt_off = gt_cxy - torch.floor(gt_cxy)

        # responsibility: shape-IOU of the anchor priors with the gt box
        anchors = torch.as_tensor(self.boxes, dtype=dt, device=dev)          # [A, 2]
        a_inter = (torch.minimum(anchors[:, 0], gt_wh[..., None, 0])
                   * torch.minimum(anchors[:, 1], gt_wh[..., None, 1]))
        a_union = (anchors[:, 0] * anchors[:, 1]
                   + (gt_wh[..., 0] * gt_wh[..., 1])[..., None] - a_inter)
        anchor_iou = a_inter / torch.clamp_min(a_union, 1e-9)               # [B, H, W, A]
        resp = torch.nn.functional.one_hot(torch.argmax(anchor_iou, dim=-1), A).to(dt)
        resp = resp * obj[..., None]

        # the TRUE IOU of each anchor's decoded box with the gt box
        cell_x = torch.arange(W, dtype=dt, device=dev)[None, None, :, None]
        cell_y = torch.arange(H, dtype=dt, device=dev)[None, :, None, None]
        pcx = cell_x + pxy[..., 0]
        pcy = cell_y + pxy[..., 1]
        px1, px2 = pcx - pwh[..., 0] / 2, pcx + pwh[..., 0] / 2
        py1, py2 = pcy - pwh[..., 1] / 2, pcy + pwh[..., 1] / 2
        ix = torch.clamp_min(torch.minimum(px2, gt_box[..., None, 2])
                             - torch.maximum(px1, gt_box[..., None, 0]), 0.0)
        iy = torch.clamp_min(torch.minimum(py2, gt_box[..., None, 3])
                             - torch.maximum(py1, gt_box[..., None, 1]), 0.0)
        inter = ix * iy
        union = pwh[..., 0] * pwh[..., 1] + (gt_wh[..., 0] * gt_wh[..., 1])[..., None] - inter
        true_iou = inter / torch.clamp_min(union, 1e-9)

        coord = torch.sum(resp * (
            torch.sum((pxy - gt_off[..., None, :]) ** 2, dim=-1)
            + torch.sum((torch.sqrt(pwh) - torch.sqrt(gt_wh)[..., None, :]) ** 2, dim=-1)))
        conf_pos = torch.sum(resp * (pconf - true_iou) ** 2)
        conf_neg = torch.sum((1.0 - resp) * pconf ** 2)
        cls_loss = -torch.sum(obj[..., None] * gt_cls * torch.log(torch.clamp_min(
            torch.sum(resp[..., None] * pcls, dim=3), 1e-9)))
        total = (self.lambda_coord * coord + conf_pos + self.lambda_no_obj * conf_neg
                 + cls_loss)
        return total / B if average else total


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> float:
    """IOU of two (x1, y1, x2, y2) boxes (YoloUtils.iou)."""
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


class DetectedObject:
    """One decoded detection (DetectedObject.java)."""

    def __init__(self, box, confidence, class_idx, class_probs):
        self.box = box  # (x1, y1, x2, y2) in grid units
        self.confidence = float(confidence)
        self.class_idx = int(class_idx)
        self.class_probs = class_probs

    def __repr__(self):
        return f"DetectedObject(cls={self.class_idx}, conf={self.confidence:.3f}, box={self.box})"


def get_predicted_objects(layer: Yolo2OutputLayer, grid_out, n_classes: int,
                          threshold: float = 0.5) -> List[List[DetectedObject]]:
    """Per-image detections above ``threshold`` from the network output
    (YoloUtils.getPredictedObjects); decoded on the host."""
    g = grid_out if isinstance(grid_out, torch.Tensor) else torch.as_tensor(np.asarray(grid_out))
    with torch.no_grad():
        pxy, pwh, pconf, pcls = (t.float().cpu().numpy()
                                 for t in layer.activate(g, n_classes))
    B, H, W, A = pconf.shape
    out: List[List[DetectedObject]] = []
    for b in range(B):
        dets: List[DetectedObject] = []
        for i in range(H):
            for j in range(W):
                for a in range(A):
                    conf = pconf[b, i, j, a]
                    if conf < threshold:
                        continue
                    cx = j + pxy[b, i, j, a, 0]
                    cy = i + pxy[b, i, j, a, 1]
                    w, h = pwh[b, i, j, a]
                    box = (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
                    probs = pcls[b, i, j, a]
                    dets.append(DetectedObject(box, conf, int(np.argmax(probs)), probs))
        out.append(dets)
    return out


def non_max_suppression(dets: List[DetectedObject], iou_threshold: float = 0.45
                        ) -> List[DetectedObject]:
    """Greedy class-wise non-max suppression (YoloUtils.nms)."""
    keep: List[DetectedObject] = []
    for cls in {d.class_idx for d in dets}:
        cand = sorted((d for d in dets if d.class_idx == cls), key=lambda d: -d.confidence)
        while cand:
            best = cand.pop(0)
            keep.append(best)
            cand = [d for d in cand
                    if iou_xyxy(np.asarray(best.box), np.asarray(d.box)) < iou_threshold]
    return keep
