"""K4's plain version (`apply_wave_plain`) against the JAX package's jitted
`wave_select` + `apply_actions_batch`, on the crafted waves of
tests/wave_cases.py: the cases a kernel built on per-group tables could get
wrong (a tie whose lower-index entry is no candidate, signed zeros, source
hosts shared in one wave, relays that hand a leadership back, a wave one
entry per broker wide). The card tests run the same waves through the CUDA
kernel against the plain version.

Every wave is padded with unflagged entries to one length, so the JAX side
compiles once per wave family (one leg; two-leg relays). Tolerance: the
selection and every aggregate exact, floats bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import wave_cases

from cruise_control_tpu.analyzer import actions as jact
from cruise_control_tpu.analyzer import context as jctx
from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
from cruise_control_tpu.models.flat_model import FlatClusterModel as JModel
from cruise_control_torch.analyzer import context as tctx
from cruise_control_torch.config.balancing import BalancingConstraint as TConstraint
from cruise_control_torch.kernels.apply_wave import apply_wave_plain
from cruise_control_torch.models.flat_model import from_numpy

#: every wave's length after padding
N = wave_cases.NUM_BROKERS
CASES = ("not_a_candidate", "signed_zeros", "shared_source_hosts", "relays_e_is_b", "bulk_width")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's intra-op
    threads would outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ctx():
    arrays = wave_cases.cluster_arrays()
    jm, tm = JModel(**arrays), from_numpy(arrays)
    jd, td = jctx.dims_of(jm), tctx.dims_of(tm)
    js = jctx.build_static_ctx(jm, JConstraint.default(), jd)
    ts = tctx.build_static_ctx(tm, TConstraint.default(), td)
    ja = jctx.compute_aggregates(js, jnp.asarray(arrays["assignment"]), jd)
    ta = tctx.compute_aggregates(ts, tm.assignment, td)

    def jax_wave(agg, score, ok, tag, legs, brokers3):
        acts = [jact.build_selected(js.part_load, agg.assignment, *leg) for leg in legs]
        host = js.broker_host
        sel = jctx.wave_select(
            score, acts[0].src, acts[0].dst, host[acts[0].dst], ok, jd.num_brokers, jd.num_hosts,
            dst_host2=host[acts[1].dst] if len(acts) > 1 else None,
            parts=tuple(a.p for a in acts), num_partitions=jd.num_partitions,
            brokers3=acts[1].dst if brokers3 else None)
        for a in acts:
            agg = jctx.apply_actions_batch(js, agg, a, sel, tag=tag)
        return sel, agg

    return dict(ts=ts, ja=ja, ta=ta, jax_wave=jax.jit(jax_wave, static_argnames=("brokers3",)),
                cases=wave_cases.cases(arrays, ta.host_cpu_load.numpy()))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_plain_wave_equals_jax(ctx, case):
    """(a) not_a_candidate: an equal-score lower-index entry that loses its
    other broker does not shadow the one selected; (b) signed_zeros: -0.0
    ties +0.0 in the broker and host stages; (c) shared_source_hosts: six
    selected moves from two hosts, whose CPU loads make every other order of
    a host's subtractions give other bits; (d) relays_e_is_b: relays whose
    third broker is leg 1's source; (e) bulk_width: one entry per broker."""
    w = wave_cases.pad(ctx["cases"][case], N)
    tag = tctx.make_touch_tag(3, 1)
    jsel, ja = ctx["jax_wave"](ctx["ja"], jnp.asarray(w["score"]), jnp.asarray(w["ok"]),
                               jnp.int32(jctx.make_touch_tag(3, 1)),
                               tuple(tuple(jnp.asarray(x) for x in leg) for leg in w["legs"]),
                               brokers3=w["brokers3"])
    ta = type(ctx["ta"])(*(t.clone() for t in ctx["ta"]))
    legs = [tuple(torch.from_numpy(x) for x in leg) for leg in w["legs"]]
    tsel = apply_wave_plain(ctx["ts"], ta, *legs[0], torch.from_numpy(w["score"]),
                            torch.from_numpy(w["ok"]), tag, legs[1] if len(legs) > 1 else None,
                            w["brokers3"])
    assert _bits_equal(jsel, tsel.numpy())
    assert w["occurs"](tsel.numpy()), f"{case}: the case does not occur in the selection"
    for f in ta._fields:
        assert _bits_equal(ja._asdict()[f], ta._asdict()[f].numpy()), f
    # the wave changed the state it was meant to change
    assert not torch.equal(ta.host_cpu_load, ctx["ta"].host_cpu_load)
