"""How one launch of K4 apply_wave spends its time, barrier by barrier, on one NVIDIA GPU.

    python3 scripts/k4_stage_split.py [--source PATH] [--reps 10]
                                      [--out build/k4_stage_split.json]

Copies the kernel's source (default: cruise_control_torch/csrc/apply_wave.cu;
pass an older revision's copy, e.g. from `git show <rev>:<path>`, to split
that one) into build/k4_stage_split/ with a clock64() stamp taken by thread 0
at the kernel's start, after every `__syncthreads();` of the source, and
after a barrier added before a section that thread 0 runs alone and at each
exit, builds it with the package's nvcc
flags and runs it in place of K4 (through the `apply_wave` wrapper) on
chip_smoke.py's 2,600-entry two-leg relay wave on the smoke model and on the
bulk planner's wave on its bucketed service context (k4_relay_wave,
k4_bulk_wave), each launch on a fresh copy of the aggregates. Prints, per
wave, each stamp's source line and its mean share of the launch's cycles,
with that share of the wave's device time per launch (CUDA events around
`--reps` back-to-back launches of the stamped kernel); writes the same as
JSON to --out. Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

PREAMBLE = r"""
__device__ long long k4_stamp_clock[512];
__device__ int k4_stamp_line[512];
__device__ int k4_stamp_n;
#define K4_STAMP() do { if (threadIdx.x == 0 && k4_stamp_n < 512) { \
  k4_stamp_clock[k4_stamp_n] = clock64(); k4_stamp_line[k4_stamp_n] = __LINE__; \
  ++k4_stamp_n; } } while (0)
CC_EXPORT int k4_stamps(long long* clocks, int* lines) {
  int n = 0;
  cudaMemcpyFromSymbol(&n, k4_stamp_n, sizeof(int));
  cudaMemcpyFromSymbol(clocks, k4_stamp_clock, sizeof(long long) * n);
  cudaMemcpyFromSymbol(lines, k4_stamp_line, sizeof(int) * n);
  int zero = 0;
  cudaMemcpyToSymbol(k4_stamp_n, &zero, sizeof(int));
  return n;
}
"""


def instrument(src: str) -> str:
    """`src` with the stamps: the preamble after the include of common.cuh
    (a #line directive keeps the source's line numbers), a stamp after every
    `__syncthreads();`, and in the __global__ function a stamp at its start
    and a barrier and a stamp before each `return;`, before a block that
    thread 0 runs alone (`if (threadIdx.x == 0) {` at the body's first
    level) and before its closing brace."""
    lines = src.split("\n")
    at = next(i for i, ln in enumerate(lines) if ln.startswith('#include "common.cuh"'))
    lines[at] += "\n" + PREAMBLE + f'\n#line {at + 2} "apply_wave.cu"'
    src = "\n".join(lines).replace("__syncthreads();", "__syncthreads(); K4_STAMP();")
    head = re.search(r"__global__[^{]*\{", src)
    depth, end = 1, head.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        end += 1
    body = src[head.end():end - 1].replace(
        "return;", "{ __syncthreads(); K4_STAMP(); return; }").replace(
        "\n  if (threadIdx.x == 0) {", "\n  __syncthreads(); K4_STAMP(); if (threadIdx.x == 0) {")
    return (src[:head.end()] + " K4_STAMP();" + body + "__syncthreads(); K4_STAMP();\n"
            + src[end - 1:])


def build_stamped(source: pathlib.Path):
    from cruise_control_torch.kernels import build

    text = instrument(source.read_text())
    out_dir = ROOT / "build" / "k4_stage_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    cu, so = out_dir / f"apply_wave-{tag}.cu", out_dir / f"libapply_wave-{tag}.so"
    cu.write_text(text)
    if not so.exists():
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so),
                        str(cu)], check=True)
    return ctypes.CDLL(str(so))


def split(name, lib, call, reps: int) -> dict:
    """Stamp shares of `reps` launches of `call(i)` (i = 0 .. reps - 1) and
    the device ms per launch."""
    clocks = (ctypes.c_longlong * 512)()
    lines = (ctypes.c_int * 512)()
    lib.k4_stamps(clocks, lines)  # drop the stamps of earlier launches
    runs = []
    for i in range(reps):
        call(i)
        torch.cuda.synchronize()
        n = lib.k4_stamps(clocks, lines)
        runs.append([(lines[j], clocks[j]) for j in range(n)])
    seq = [ln for ln, _ in runs[0]]
    if any([ln for ln, _ in r] != seq for r in runs):
        raise SystemExit(f"k4_stage_split: {name}: the launches took different paths")
    total = sum(r[-1][1] - r[0][1] for r in runs) / reps
    steps = [{"line": seq[j], "cycles": sum(r[j][1] - r[j - 1][1] for r in runs) / reps}
             for j in range(1, len(seq))]
    for st in steps:
        st["share"] = st["cycles"] / total
    # the device time per launch, without the stamp readback between launches
    for i in range(reps):  # warm-up on the same copies
        call(i)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        call(reps + i)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / reps
    return {"wave": name, "cycles": total, "ms": ms, "steps": steps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default=str(ROOT / "cruise_control_torch" / "csrc" / "apply_wave.cu"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "build" / "k4_stage_split.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_stage_split: needs an NVIDIA GPU")
    import chip_smoke
    from cruise_control_torch.analyzer.context import build_static_ctx, compute_aggregates, dims_of
    from cruise_control_torch.config.balancing import BalancingConstraint
    from cruise_control_torch.kernels import build
    from cruise_control_torch.kernels.apply_wave import apply_wave
    from cruise_control_torch.models import generators

    card = chip_smoke.nvidia_smi_line()
    print(card)
    source = pathlib.Path(args.source)
    build.build_all()
    lib = build_stamped(source)
    build._LIBS["apply_wave"] = lib
    prop = dataclasses.replace(generators.BASELINE_CONFIGS[5], num_dead_brokers=26,
                               load_distribution="pareto", mean_utilization=0.5)
    model_cpu = generators.random_cluster(chip_smoke.SEED, prop)
    dims = dims_of(model_cpu)
    model = model_cpu.to("cuda")
    st = build_static_ctx(model, BalancingConstraint.default(), dims)
    agg = compute_aggregates(st, model.assignment, dims)
    relay = [t.cuda() for t in chip_smoke.k4_relay_wave(model_cpu.assignment.numpy(),
                                                        dims.num_brokers)]
    st_b, agg_b, bulk_args = chip_smoke.k4_bulk_wave(model_cpu, "cuda")

    def fresh(a, count):
        return [type(a)(*(t.clone() for t in a)) for _ in range(count)]

    out = {"card": card, "source": str(source), "waves": []}
    for name, static, base, launch in (
            ("2,600-entry two-leg relay wave", st, agg,
             lambda s_, a_: chip_smoke.k4_relay_apply(apply_wave, s_, a_, relay)),
            (f"bulk planner's {bulk_args[0].shape[0]}-entry wave", st_b, agg_b,
             lambda s_, a_: apply_wave(s_, a_, *bulk_args))):
        pool = fresh(base, 2 * args.reps)
        torch.cuda.synchronize()
        res = split(name, lib, lambda i: launch(static, pool[i]), args.reps)
        out["waves"].append(res)
        print(f"{name}: {res['ms']:.4f} ms per launch (CUDA events), {res['cycles']:.0f} cycles "
              "from the first stamp to the last")
        for stp in res["steps"]:
            print(f"  to line {stp['line']:4d}: {stp['cycles']:10.0f} cycles  {stp['share']:6.3f}"
                  f"  ~{stp['share'] * res['ms'] * 1e3:8.2f} us")
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
