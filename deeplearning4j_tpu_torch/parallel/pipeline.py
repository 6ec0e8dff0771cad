"""Pipeline parallelism over a ``pipe`` mesh axis, GPipe schedule (the
PyTorch port of ``parallel/pipeline.py``).

Each ``pipe`` rank holds one stage. A step runs every micro-batch forward
through the stages (rank s receives micro-batch i's activation from rank
s - 1, applies its stage and sends the result on), the last rank scores
the outputs, and the backward runs the other way: each rank receives the
gradient of its outputs, back-propagates through its stage and sends the
gradient of its inputs back. The JAX package writes the same schedule as
one ``shard_map`` ring of ``ppermute``s; here the activations move by
point-to-point through ``parallel/comm.py`` (:func:`send_tensor` and
:func:`recv_tensor`, which send a small header first, so that a stage need
not know its neighbour's shapes).

:class:`PipelineParallel` is the low-level runner (``stage_apply(params,
x)`` and ``loss_fn(outputs, labels)``, a plain SGD step);
``parallel/gpipe.py`` builds the framework trainer on the same schedule.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from deeplearning4j_tpu_torch.parallel import comm

__all__ = ["PipelineParallel", "recv_tensor", "send_tensor", "stack_stage_params"]

_DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.float16, torch.int64,
           torch.int32, torch.uint8, torch.bool]
_HEADER = 10    # dtype code, ndim, up to 8 dims


def send_tensor(t: torch.Tensor, dst_index: int, sub) -> None:
    """Send ``t`` (any shape up to 8 dims, a dtype of ``_DTYPES``) to the
    rank at ``dst_index`` of ``sub``: a header, then the data."""
    if t.dim() > _HEADER - 2:
        raise ValueError(f"send_tensor takes up to {_HEADER - 2} dims, got {t.dim()}")
    head = [_DTYPES.index(t.dtype), t.dim()] + list(t.shape)
    head += [0] * (_HEADER - len(head))
    comm.send(torch.tensor(head, dtype=torch.int64, device=t.device), dst_index, sub)
    comm.send(t.detach(), dst_index, sub)


def recv_tensor(src_index: int, sub, device) -> torch.Tensor:
    """The tensor :func:`send_tensor` sent from the rank at ``src_index``."""
    head = comm.recv((_HEADER,), torch.int64, device, src_index, sub).tolist()
    shape = tuple(head[2:2 + head[1]])
    return comm.recv(shape, _DTYPES[head[0]], device, src_index, sub)


def run_schedule(stage, sub, n_micro, inputs, head, device):
    """One GPipe step on this rank's stage (rank ``sub.index`` of the
    ``pipe`` sub-group ``sub``). ``stage(x, i)`` is the stage's forward on
    micro-batch ``i`` (differentiable in its params, which the caller made
    leaves that require grad); ``inputs(i)`` the first stage's input of
    micro-batch i; ``head(outputs)`` the last stage's loss from the list of
    its outputs. The backward leaves the params' ``.grad`` set on this
    rank. Returns the loss on every rank (broadcast from the last)."""
    s, S = sub.index, sub.size
    kept = []
    for i in range(n_micro):
        if s == 0:
            x = inputs(i)
        else:
            x = recv_tensor(s - 1, sub, device)
            if x.is_floating_point():
                x.requires_grad_(True)
        y = stage(x, i)
        if s < S - 1:
            send_tensor(y, s + 1, sub)
        kept.append((x, y))
    if s == S - 1:
        loss = head([y for _, y in kept])
        loss.backward()
        loss = loss.detach()
    else:
        for x, y in kept:
            g = recv_tensor(s + 1, sub, device)
            torch.autograd.backward(y, g)
        loss = torch.zeros((), dtype=torch.float32, device=device)
    if s > 0:
        for x, _ in kept:
            send_tensor(x.grad if x.grad is not None else torch.zeros_like(x), s - 1, sub)
    return comm.broadcast(loss.float().contiguous(), S - 1, sub)


class PipelineParallel:
    """GPipe training runner: ``stage_apply(stage_params, x) -> y`` is one
    stage's forward (activations of one shape between stages),
    ``loss_fn(outputs [M, mb, ...], labels [M, mb, ...])`` scores the last
    stage's outputs and should be a mean over rows (with a ``data`` axis
    larger than 1 each data rank scores its rows and the loss and gradients
    are averaged). ``fit_batch`` takes the params of every stage stacked on
    a leading axis (:func:`stack_stage_params`), updates this rank's stage
    with plain SGD and returns ``(new stacked params, loss)``, every stage's
    row gathered back on every rank."""

    def __init__(self, stage_apply: Callable, n_stages: int, mesh, *, loss_fn: Callable,
                 data_axis: str = "data", pipe_axis: str = "pipe",
                 learning_rate: float = 1e-2):
        if n_stages != mesh.shape[pipe_axis]:
            raise ValueError(
                f"n_stages={n_stages} must equal the mesh's '{pipe_axis}' axis size "
                f"({mesh.shape[pipe_axis]}): one stage per pipe rank")
        self.stage_apply = stage_apply
        self.n_stages = n_stages
        self.mesh = mesh
        self.loss_fn = loss_fn
        self.data_axis = data_axis
        self.pipe_axis = pipe_axis
        self.lr = learning_rate

    def fit_batch(self, stacked_params, x, y, n_micro: int):
        """Split [B, ...] into ``n_micro`` micro-batches (this data rank's
        rows of each) and run one pipelined SGD step."""
        from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

        B = x.shape[0]
        if B % n_micro:
            raise ValueError("batch must divide into microbatches")
        pipe, data = self.mesh.sub(self.pipe_axis), self.mesh.sub(self.data_axis)
        mb = B // n_micro
        if mb % data.size:
            raise ValueError(f"microbatch size {mb} must divide the '{self.data_axis}' "
                             f"axis ({data.size})")
        lo, hi = data.index * mb // data.size, (data.index + 1) * mb // data.size
        xm = x.reshape((n_micro, mb) + tuple(x.shape[1:]))[:, lo:hi]
        ym = y.reshape((n_micro, mb) + tuple(y.shape[1:]))[:, lo:hi]
        s = pipe.index
        mine = tree_map(lambda a: a[s], stacked_params)
        leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(mine)]
        params = tree_unflatten_like(mine, leaves)
        loss = run_schedule(lambda xi, i: self.stage_apply(params, xi), pipe, n_micro,
                            lambda i: xm[i], lambda outs: self.loss_fn(torch.stack(outs), ym),
                            xm.device)
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
            if data.size > 1:
                grads = [comm.all_reduce(g.contiguous(), data) / data.size for g in grads]
                loss = comm.all_reduce(loss.clone(), data) / data.size
            new = [p.detach() - self.lr * g for p, g in zip(leaves, grads)]
            rows = [torch.stack(comm.all_gather(n, pipe)) for n in new]
        return tree_unflatten_like(stacked_params, rows), loss


def stack_stage_params(per_stage: Sequence[Any]):
    """Stack per-stage param trees on a new leading ``pipe`` axis."""
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_unflatten_like

    cols = zip(*(tree_leaves(t) for t in per_stage))
    return tree_unflatten_like(per_stage[0], [torch.stack(c) for c in cols])
