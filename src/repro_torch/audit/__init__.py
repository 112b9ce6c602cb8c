"""The port's audit of its structural contracts (counterpart of
``repro/audit``).

The paper's claim -- inference "without the use of any multipliers" -- is a
property of the program, not of one run.  The reference proves it on the
jaxpr of its jitted serving steps; the port has no traced program, so it
records its serving steps once each under a ``TorchDispatchMode``, every
aten op in order and every hand-written kernel launch as an opaque leaf,
and checks the same rules on the recording:

* :func:`record` / :func:`op_census` -- the recorder (``pallas_call``'s
  counterpart: the kernels are leaves, reported by their wrappers)
* :func:`multiplier_free_violations`, :func:`zero_copy_violations`,
  :func:`plan_consistency_violations`, :func:`inplace_violations`,
  :func:`overflow_violations` -- the rule classes (empty list == the
  invariant holds); ``inplace`` stands for the reference's ``donation``
* :func:`interval_eval` / :func:`layer_range_cert` /
  :func:`precision_report` -- the range/overflow pass: interval abstract
  interpretation over the recorded steps plus closed-form per-plan
  accumulator and error-bound certificates
* :data:`AUDIT_POINTS` / :func:`audit_point` / :func:`trace_point` -- the
  audited matrix (one recording per step per point)
* :func:`build_manifest` & friends -- the JSON manifest behind
  ``python -m repro_torch.audit --check`` and ``--write``

The reference's HLO pass (donation aliases, collective traffic) has no
counterpart on one card's eager steps; its ``blocks_over_vmem`` is
``blocks_over_smem`` here (the Hopper tiles of ``kernels.lut_affine.autotune``).
See "Audited invariants (port)" in the
README for the rule table.
"""
from repro_torch.audit.inplace import inplace_violations, state_shapes, storage_map
from repro_torch.audit.interp import (
    INT_INPUT_BOUND,
    Interval,
    OverflowFact,
    dtype_interval,
    input_interval,
    interval_eval,
)
from repro_torch.audit.manifest import (
    ManifestError,
    build_manifest,
    diff_manifests,
    load_manifest,
    manifest_violations,
    write_manifest,
)
from repro_torch.audit.points import (
    AUDIT_POINTS,
    AuditPoint,
    audit_point,
    build_point,
    trace_point,
)
from repro_torch.audit.ranges import (
    RangeCert,
    kernel_interval_model,
    layer_range_cert,
    overflow_violations,
    precision_report,
)
from repro_torch.audit.rules import (
    Violation,
    multiplier_free_violations,
    plan_consistency_violations,
    planned_weight_shapes,
    table_leaf_shapes,
    zero_copy_violations,
)
from repro_torch.audit.walker import OPAQUE_KERNELS, as_ops, op_census, record

__all__ = [
    "AUDIT_POINTS",
    "AuditPoint",
    "INT_INPUT_BOUND",
    "Interval",
    "ManifestError",
    "OPAQUE_KERNELS",
    "OverflowFact",
    "RangeCert",
    "Violation",
    "as_ops",
    "audit_point",
    "build_manifest",
    "build_point",
    "diff_manifests",
    "dtype_interval",
    "inplace_violations",
    "input_interval",
    "interval_eval",
    "kernel_interval_model",
    "layer_range_cert",
    "load_manifest",
    "manifest_violations",
    "multiplier_free_violations",
    "op_census",
    "overflow_violations",
    "plan_consistency_violations",
    "planned_weight_shapes",
    "precision_report",
    "record",
    "state_shapes",
    "storage_map",
    "table_leaf_shapes",
    "trace_point",
    "write_manifest",
    "zero_copy_violations",
]
