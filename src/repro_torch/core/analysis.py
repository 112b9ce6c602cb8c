"""Analytic reproduction of the paper's tables (counterpart of
``repro/core/analysis.py``): LUT sizes, evaluations and shift-adds of the
paper's three networks, exactly from :class:`LUTPlan` accounting.  Pure
host arithmetic on plans; nothing here touches a tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.lut import LUTPlan
from repro_torch.core.planner import enumerate_plans
from repro_torch.core.quantize import FixedPointFormat, Float16Format

KiB = 2**10
MiB = 2**20
GiB = 2**30


@dataclasses.dataclass(frozen=True)
class LayerShape:
    in_features: int
    out_features: int


# The paper's three example networks (dense/affine layers only -- ReLU,
# pooling and argmax are comparison-free in both implementations).
LINEAR_CLASSIFIER = (LayerShape(784, 10),)
MLP = (LayerShape(784, 1024), LayerShape(1024, 512), LayerShape(512, 10))
# LeNet-ish CNN from the TF tutorial, dense view of each layer: conv1
# 5x5x1->32 (28x28 'same'), conv2 5x5x32->64 (14x14), fc 3136->1024, fc
# 1024->10.  Conv layers share one table set across positions, so their
# table cost is position-independent while their op count scales with
# positions.
CNN_DENSE = (LayerShape(3136, 1024), LayerShape(1024, 10))
CNN_CONVS = (
    # (patch_size q, out_channels p, spatial positions)
    (25, 32, 28 * 28),
    (25 * 32, 64, 14 * 14),
)


def network_cost(
    layers: Sequence[LayerShape], fmt, chunk_size: int, mode: str = "bitplane"
) -> dict:
    """Aggregate (tables, bytes, evals, shift-adds) over dense layers."""
    tables = bytes_ = evals = adds = 0
    for shape in layers:
        plan = LUTPlan(
            shape.in_features, shape.out_features, chunk_size, fmt, mode=mode
        )
        tables += plan.num_chunks
        bytes_ += plan.total_lut_bytes
        evals += plan.lut_evaluations
        adds += plan.shift_add_ops
    return dict(tables=tables, bytes=bytes_, evals=evals, shift_adds=adds)


def conv_layer_cost(
    patch: int, out_ch: int, positions: int, fmt, chunk_size: int
) -> dict:
    """Paper §Convolutional layers: one table set shared across positions;
    evaluations and adds multiply by the output positions (spatial
    shift-and-add)."""
    plan = LUTPlan(patch, out_ch, chunk_size, fmt)
    return dict(
        tables=plan.num_chunks,
        bytes=plan.total_lut_bytes,
        evals=plan.lut_evaluations * positions,
        shift_adds=plan.shift_add_ops * positions + out_ch * (positions - 1),
    )


def paper_claims() -> dict:
    """Every inline number of the paper, recomputed from the formulas."""
    fp3 = FixedPointFormat(3, 3)  # 3-bit input pixels in [0, 1)
    f16 = Float16Format()

    lin14 = LUTPlan(784, 10, 14, fp3)  # the "56 LUTs" configuration
    lin1 = LUTPlan(784, 10, 1, fp3)  # the "784 LUTs" configuration

    mlp_bp = network_cost(MLP, f16, 1, mode="bitplane")
    mlp_full = network_cost(MLP, f16, 1, mode="full")

    cnn_dense = network_cost(CNN_DENSE, f16, 1, mode="bitplane")
    cnn_convs = [conv_layer_cost(q, p, pos, f16, 1) for q, p, pos in CNN_CONVS]
    cnn_total_bytes = cnn_dense["bytes"] + sum(c["bytes"] for c in cnn_convs)
    cnn_total_adds = cnn_dense["shift_adds"] + sum(c["shift_adds"] for c in cnn_convs)

    return {
        # paper: "56 LUTs ... 17.5 Mebibytes, 168 LUT evaluations and 1650
        # shift-and-add operations"
        "linear_m14": dict(
            tables=lin14.num_chunks,
            mib=lin14.total_lut_bytes / MiB,
            evals=lin14.lut_evaluations,
            shift_adds=lin14.shift_add_ops,
        ),
        # paper: "784 LUTs totaling about 30.6 Kibibytes ... 23520 shift-adds"
        "linear_m1": dict(
            tables=lin1.num_chunks,
            kib=lin1.total_lut_bytes / KiB,
            shift_adds=lin1.shift_add_ops,
        ),
        # paper: "2320 LUTs with a combined size of 162.6 Mebibytes and
        # 14652918 shift-and-add operations"
        "mlp_bitplane": dict(
            tables=mlp_bp["tables"],
            mib=mlp_bp["bytes"] / MiB,
            shift_adds=mlp_bp["shift_adds"],
        ),
        # paper: "2320 LUTs ... 1330678 addition operations" (full 16-bit
        # indexing)
        "mlp_full": dict(
            tables=mlp_full["tables"],
            gib=mlp_full["bytes"] / GiB,
            adds=mlp_full["shift_adds"],
        ),
        # paper: "total LUT size is 400 Mebibytes ... 37.4M shift+add"
        "cnn_bitplane": dict(mib=cnn_total_bytes / MiB, shift_adds=cnn_total_adds),
        # reference model op counts quoted by the paper
        "linear_ref_madds": 784 * 10,
        "mlp_ref_madds": 784 * 1024 + 1024 * 512 + 512 * 10,
    }


def figure_curve(layers: Sequence[LayerShape], fmt, modes=("bitplane", "full")):
    """Fig. 5/7/8-style curve: total size against ops across chunk sizes,
    applied uniformly across layers as in the paper; sorted by size."""
    rows = []
    probe = enumerate_plans(layers[0].in_features, layers[0].out_features, fmt, modes)
    seen = sorted({(p.plan.mode, p.plan.chunk_size) for p in probe})
    for mode, m in seen:
        try:
            cost = network_cost(layers, fmt, m, mode=mode)
        except ValueError:
            continue
        rows.append(dict(mode=mode, chunk=m, **cost))
    return sorted(rows, key=lambda r: r["bytes"])
