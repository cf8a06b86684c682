"""chip_smoke.py phase 25's JAX references: the JAX package's model API on
the smoke model, jitted on the CPU.

    JAX_PLATFORMS=cpu python scripts/model_api_references.py [--port]

Builds the smoke model (chip_smoke's recipe: BASELINE config 5 with 26 dead
brokers, pareto load at mean utilization 0.5, seed 42) with the JAX
package's generator, runs `chip_smoke.model_api_outputs` on the JAX
package's flat-model helpers and gather_actions (each under `jax.jit`),
and prints `JAX_CPU_MODEL_API`: each output's SHA-256. With `--port` it
runs the port's API on the CPU too and says whether each hash is equal.
Takes about a minute and a few hundred MB on a CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from cruise_control_tpu.analyzer import actions as jact  # noqa: E402
from cruise_control_tpu.models import flat_model as jfm  # noqa: E402
from cruise_control_tpu.models import generators as jgen  # noqa: E402


def jax_api():
    """The JAX package's model API in `chip_smoke.model_api_outputs`' form,
    every function jitted."""
    names = ("replication_factor", "new_broker_mask", "dead_broker_mask", "leader_contribution",
             "follower_contribution", "utilization_matrix")
    api = {n: jax.jit(getattr(jfm, n)) for n in names}
    api["host_loads"] = jax.jit(jfm.host_loads, static_argnums=1)
    api["host_capacity"] = jax.jit(jfm.host_capacity, static_argnums=1)
    picks = jax.jit(lambda m, rows, slots: jact.gather_actions(
        jact.make_leadership_batch(m.part_load, m.assignment), rows, slots))
    return types.SimpleNamespace(
        **api, host_count=lambda m: int(np.asarray(m.broker_host).max()) + 1,
        leadership_picks=picks)


def jax_models():
    """(the smoke model, the same with its brokers MODEL_API_HOST_GROUP a
    host) in the JAX package."""
    prop = dataclasses.replace(jgen.BASELINE_CONFIGS[5], num_dead_brokers=26,
                               load_distribution="pareto", mean_utilization=0.5)
    model = jgen.random_cluster(chip_smoke.SEED, prop)
    hosts = np.arange(model.num_brokers, dtype=np.int32) // chip_smoke.MODEL_API_HOST_GROUP
    return model, model._replace(broker_host=jax.numpy.asarray(hosts))


def references() -> dict:
    """`JAX_CPU_MODEL_API`, recomputed."""
    model, grouped = jax_models()
    return chip_smoke.outputs_sha256(chip_smoke.model_api_outputs(jax_api(), model, grouped),
                                     np.asarray)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", action="store_true",
                    help="also run the port's API on the CPU and compare the hashes")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    ref = references()
    print("JAX_CPU_MODEL_API = " + json.dumps(ref, indent=4))
    if args.port:
        import torch

        from cruise_control_torch.models.flat_model import from_numpy

        model, grouped = jax_models()
        tm = from_numpy({k: np.asarray(v) for k, v in model._asdict().items()})
        tg = from_numpy({k: np.asarray(v) for k, v in grouped._asdict().items()})
        torch.set_num_threads(4)
        port = chip_smoke.outputs_sha256(
            chip_smoke.model_api_outputs(chip_smoke.port_model_api(), tm, tg),
            lambda x: x.numpy())
        for label, sha in ref.items():
            print(f"{label}: {'equal' if port[label] == sha else 'DIFFERS'}")
        return 0 if port == ref else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
