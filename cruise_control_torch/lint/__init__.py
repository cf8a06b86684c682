"""cclint for the PyTorch port: static analysis of the CUDA, concurrency,
registry and dispatch-level invariants `cruise_control_torch` rests on.

The counterpart of the JAX package's linter, with its module names, CLI,
exit codes, suppression syntax and JSON schema v2. Two tiers. The `token`
tier is pure AST/text analysis (no torch import): `cuda` guards the round
code around the hand kernels against host syncs, per-element launches,
size-picked launch sequences, stale aliases of tensors written in place and
padded denominators; `concurrency` and `registry` are the JAX package's
families, unchanged. The `trace` tier runs the REAL kernel entry points
registered in lint/entrypoints.py in a worker subprocess under a PyTorch
dispatch recorder (on the card also under `torch.cuda.set_sync_debug_mode`)
and checks what the token rules cannot see: host syncs, in-place writes
against each entry's declaration, carried dtypes and shapes, tensors held
by the entry's closure, and the mesh's collectives, with results cached by
the sources' content hash. CLI: `python -m cruise_control_torch.lint`.
"""

from cruise_control_torch.lint.core import (  # noqa: F401
    EXIT_CLEAN,
    EXIT_ERROR,
    EXIT_FINDINGS,
    Finding,
    LintContext,
    Rule,
    RULES,
    TIERS,
    all_rules,
    build_context,
    render_human,
    render_json,
    run_rules,
    tier_rules,
    unsuppressed,
)
