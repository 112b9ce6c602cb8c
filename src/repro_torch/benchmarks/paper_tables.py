"""Analytic reproduction of every derivable paper table and figure
(counterpart of ``benchmarks/paper_tables.py``; the same names and values):

  Fig. 5    -> linear-classifier LUT size against shift-adds
  Fig. 7    -> MLP trade-off (binary16 bitplane + full-bits points)
  Fig. 8    -> CNN trade-off
  inline    -> the paper's quoted numbers (56 LUTs / 17.5 MiB / 168 evals,
               2320 LUTs / 162.6 MiB / 14,652,918 adds, ...)

Fig. 4/6 (accuracy against input bits) is measured, in
``accuracy_vs_bits.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.paper_tables
"""
from __future__ import annotations

from repro_torch.core.analysis import (
    CNN_CONVS,
    CNN_DENSE,
    LINEAR_CLASSIFIER,
    MLP,
    MiB,
    conv_layer_cost,
    figure_curve,
    network_cost,
    paper_claims,
)
from repro_torch.core.quantize import FixedPointFormat, Float16Format


def rows() -> list[tuple[str, float, str]]:
    out = []
    claims = paper_claims()
    lin = claims["linear_m14"]
    out.append(("paper/linear_m14_tables", lin["tables"], "paper=56"))
    out.append(("paper/linear_m14_MiB", round(lin["mib"], 2), "paper=17.5"))
    out.append(("paper/linear_m14_evals", lin["evals"], "paper=168"))
    out.append(("paper/linear_m14_adds", lin["shift_adds"], "paper~1650"))
    out.append(
        ("paper/linear_m1_KiB", round(claims["linear_m1"]["kib"], 1), "paper=30.6")
    )
    mlp = claims["mlp_bitplane"]
    out.append(("paper/mlp_tables", mlp["tables"], "paper=2320"))
    out.append(("paper/mlp_MiB", round(mlp["mib"], 1), "paper=162.6"))
    out.append(("paper/mlp_adds", mlp["shift_adds"], "paper=14652918 (exact)"))
    out.append(
        ("paper/mlp_full_adds", claims["mlp_full"]["adds"], "paper=1330678 (exact)")
    )
    out.append(("paper/cnn_MiB", round(claims["cnn_bitplane"]["mib"], 0), "paper~400"))
    out.append(("paper/mlp_ref_madds", claims["mlp_ref_madds"], "paper=1332224"))

    # Fig. 5: linear classifier, 3-bit fixed point, both modes
    for r in figure_curve(LINEAR_CLASSIFIER, FixedPointFormat(3, 3)):
        out.append(
            (f"fig5/{r['mode']}_m{r['chunk']}", r["shift_adds"], f"lut_bytes={r['bytes']}")
        )
    # Fig. 7: MLP fp16
    for r in figure_curve(MLP, Float16Format())[:8]:
        out.append(
            (
                f"fig7/{r['mode']}_m{r['chunk']}",
                r["shift_adds"],
                f"lut_MiB={r['bytes'] / MiB:.1f}",
            )
        )
    # Fig. 8: CNN = conv layers (shared tables) + dense layers
    for m in (1, 2, 3):
        dense = network_cost(CNN_DENSE, Float16Format(), m)
        convs = [
            conv_layer_cost(q, p, pos, Float16Format(), m) for q, p, pos in CNN_CONVS
        ]
        total_b = dense["bytes"] + sum(c["bytes"] for c in convs)
        total_a = dense["shift_adds"] + sum(c["shift_adds"] for c in convs)
        out.append((f"fig8/bitplane_m{m}", total_a, f"lut_MiB={total_b / MiB:.1f}"))
    return out


if __name__ == "__main__":
    for name, value, note in rows():
        print(f"{name:28s} {value:>14} {note}")
