"""Public wrappers of the kernel layer, with the dispatch by device.

A tensor on the CPU takes the plain version in ``ref.py``; a tensor on a
CUDA device launches the hand-written kernel, and a failed build or launch
raises. There is no fallback from the kernel to the plain version. Core
code imports only this module, never the kernels directly.

``launch_counts()`` reads each kernel wrapper's count of launches and
``reset_launch_counts()`` sets them to 0, so a run can show that it went
through the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import assign_stats as _assign_stats_k
from repro_torch.kernels import ref
from repro_torch.kernels import sim_best_edge as _sim_best_edge_k


def launch_counts() -> dict[str, int]:
    return {
        "sim_best_edge": _sim_best_edge_k.launches,
        "label_stats": _assign_stats_k.launches["label_stats"],
        "assign_stats": _assign_stats_k.launches["assign_stats"],
    }


def reset_launch_counts() -> None:
    _sim_best_edge_k.launches = 0
    for name in _assign_stats_k.launches:
        _assign_stats_k.launches[name] = 0


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: expected cpu or cuda")


# ---------------------------------------------------------------- assign


def assign_argmax(
    x: torch.Tensor, centers: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,d),(k,d) -> ((n,) best center idx, (n,) best similarity).

    Only the fused K-Means path is ported to the card; this one's kernel
    is not written yet.
    """
    if _on_card(x):
        raise NotImplementedError(
            "assign_argmax has no CUDA kernel yet (ROADMAP queue 2, item 6); "
            "use fused=True"
        )
    return ref.assign_argmax(x, centers)


class AssignStats(NamedTuple):
    """Everything one K-Means iteration needs from a pass over x."""

    idx: torch.Tensor  # (n,) int32 nearest-center assignment
    best_sim: torch.Tensor  # (n,) f32 best similarity
    sums: torch.Tensor  # (k, d) f32 weighted per-cluster sums
    counts: torch.Tensor  # (k,) f32 per-cluster weight totals
    min_sim: torch.Tensor  # (k,) f32 lowest member similarity (ref.BIG if empty)
    sumsq: torch.Tensor  # (k,) f32 weighted sum of squared row norms


def assign_stats(
    x: torch.Tensor, centers: torch.Tensor, w: torch.Tensor | None = None
) -> AssignStats:
    """Fused map+combine: nearest center AND cluster statistics.

    ``w`` optionally weights rows; weight-0 rows are excluded everywhere.
    """
    if _on_card(x):
        return AssignStats(*_assign_stats_k.assign_stats_cuda(
            x.contiguous(), centers.contiguous(),
            None if w is None else w.float().contiguous(),
        ))
    return AssignStats(*ref.assign_stats_scatter(x, centers, w))


def stats_identity(
    k: int, d: int, device: str | torch.device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Identity of the carried (sums, counts, min_sim, sumsq) fold."""
    return (
        torch.zeros((k, d), dtype=torch.float32, device=device),
        torch.zeros((k,), dtype=torch.float32, device=device),
        torch.full((k,), ref.BIG, dtype=torch.float32, device=device),
        torch.zeros((k,), dtype=torch.float32, device=device),
    )


def merge_stats(
    carry: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    st: AssignStats,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one chunk's AssignStats into the carried accumulators."""
    sums, counts, min_sim, sumsq = carry
    return (
        sums + st.sums,
        counts + st.counts,
        torch.minimum(min_sim, st.min_sim),
        sumsq + st.sumsq,
    )


# ---------------------------------------------------------------- label stats


def label_stats(
    x: torch.Tensor, idx: torch.Tensor, k: int, w: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,d),(n,)[,(n,)] -> ((k,d) weighted sums, (k,) weight totals).

    Labels outside [0, k) (e.g. -1 padding) and weight-0 rows contribute
    nothing.
    """
    if _on_card(x):
        return _assign_stats_k.label_stats_cuda(
            x.contiguous(), idx.to(torch.int32).contiguous(), k,
            None if w is None else w.float().contiguous(),
        )
    return ref.label_stats_scatter(x, idx, k, w)


# ---------------------------------------------------------------- fused sim+edge


def sim_best_edge(
    xs_rows: torch.Tensor,
    xs_all: torch.Tensor,
    labels_row: torch.Tensor,
    labels_col: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row best cross-component edge with the similarity build fused in.

    On the card the (r, c) similarity matrix never reaches device memory; on
    the CPU the plain version builds it.
    """
    lr = labels_row.to(torch.int32)
    lc = labels_col.to(torch.int32)
    if _on_card(xs_rows):
        return _sim_best_edge_k.sim_best_edge_cuda(
            xs_rows.contiguous(), xs_all.contiguous(), lr.contiguous(),
            lc.contiguous(),
        )
    return ref.sim_best_edge(xs_rows, xs_all, lr, lc)
