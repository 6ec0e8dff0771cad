"""Observability stack (deeplearning4j-ui-parent parity).

Reference chain: StatsListener (ui-model/.../stats/BaseStatsListener.java:43,
iterationDone:304 — score, per-param histograms/means/stdev of
weights/updates, memory, timing) -> StatsStorageRouter -> StatsStorage impls
(InMemory/File, ui/storage/) -> PlayUIServer train modules
(/train/overview, /train/model, /train/system).

PyTorch port of ``deeplearning4j_tpu/ui``: the same records, storage
files and pages, so a dashboard of either package reads the other's stats.
Stats are plain JSON records (no SBE/Agrona binary
encoding — that existed for JVM off-heap buffers); the dashboard is ONE
self-contained static HTML file with inline SVG charts (no Play server, no
external JS, works air-gapped), plus the same attach() surface so training
jobs stream into storage and the page re-renders on demand.
"""

from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram,
    ChartHorizontalBar,
    ChartLine,
    ChartScatter,
    ChartStackedArea,
    ChartTimeline,
    Component,
    ComponentDiv,
    ComponentTable,
    ComponentText,
    render_html,
    save_html,
)
from deeplearning4j_tpu_torch.ui.convolutional import ConvolutionalIterationListener
from deeplearning4j_tpu_torch.ui.stats import StatsListener
from deeplearning4j_tpu_torch.ui.storage import (
    FileStatsStorage,
    InMemoryStatsStorage,
    RemoteStatsStorageRouter,
    StatsStorage,
)
from deeplearning4j_tpu_torch.ui.server import UIServer

__all__ = [
    "StatsListener",
    "ConvolutionalIterationListener",
    "StatsStorage",
    "InMemoryStatsStorage",
    "FileStatsStorage",
    "RemoteStatsStorageRouter",
    "UIServer",
    "Component",
    "ChartLine",
    "ChartScatter",
    "ChartHistogram",
    "ChartHorizontalBar",
    "ChartStackedArea",
    "ChartTimeline",
    "ComponentText",
    "ComponentTable",
    "ComponentDiv",
    "render_html",
    "save_html",
]
