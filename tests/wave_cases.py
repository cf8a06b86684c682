"""Crafted waves for K4 apply_wave, shared by the CPU tests against the JAX
package (test_torch_wave_select.py) and the card tests against the plain
version (test_torch_kernels_cuda.py). No JAX here: the card's machine has
none.

Each case is a dict: `legs` (one or two (p, kind, slot, dst) tuples of
i32[N]), `score` f32[N], `ok` bool[N], `brokers3`, and `occurs(sel)`, which
says whether the case's point shows in a selection (bool[N] numpy).
"""

from __future__ import annotations

import itertools

import numpy as np

from cruise_control_torch.models import generators

NUM_BROKERS = 24
#: three brokers a host: eight hosts, so one wave can select several
#: entries whose sources share a host
BROKERS_PER_HOST = 3
CPU_LEADER, CPU_FOLLOWER = 0, 1


def cluster_arrays() -> dict:
    """The numpy fields of a small rack-aware pareto cluster with 2 dead
    brokers and three brokers per host, six of whose partitions carry CPU
    loads planted for shared_source_hosts."""
    prop = generators.ClusterProperty(num_racks=4, num_brokers=NUM_BROKERS, num_topics=60,
                                      mean_partitions_per_topic=10.0, replication_factor=3,
                                      num_dead_brokers=2, load_distribution="pareto",
                                      mean_utilization=0.5)
    arrays = {k: np.asarray(v).copy() for k, v in generators.random_cluster(42, prop)._asdict().items()}
    arrays["broker_host"] = (np.arange(NUM_BROKERS) // BROKERS_PER_HOST).astype(np.int32)
    _plant_order_sensitive_loads(arrays)
    return arrays


def _wave(entries, brokers3=False):
    """entries: (p, kind, slot, dst, score[, p2, kind2, slot2, dst2])."""
    cols = list(zip(*entries))
    legs = [tuple(np.asarray(c, dtype=np.int32) for c in cols[:4])]
    if len(cols) > 5:
        legs.append(tuple(np.asarray(c, dtype=np.int32) for c in cols[5:9]))
    score = np.asarray(cols[4], dtype=np.float32)
    return {"legs": legs, "score": score, "ok": np.ones(len(entries), dtype=bool),
            "brokers3": brokers3}


def pad(wave: dict, n: int) -> dict:
    """The wave with unflagged entries appended up to `n`."""
    n0 = wave["score"].shape[0]
    k = n - n0
    out = dict(wave)
    out["occurs"] = lambda sel: wave["occurs"](sel[:n0])
    out["legs"] = [tuple(np.concatenate([x, np.zeros(k, np.int32)]) for x in leg)
                   for leg in wave["legs"]]
    out["score"] = np.concatenate([wave["score"], np.zeros(k, np.float32)])
    out["ok"] = np.concatenate([wave["ok"], np.zeros(k, bool)])
    return out


def _move_from(a, b, avoid, rng, parts_used):
    """(p, slot) of a replica on broker `b` of a partition not yet used
    that has no replica on any broker in `avoid`."""
    where = [(p, s) for p, s in np.argwhere(a == b)
             if p not in parts_used and not np.isin(a[p], list(avoid)).any()]
    p, s = where[rng.integers(0, len(where))]
    parts_used.add(int(p))
    return int(p), int(s)


def not_a_candidate(a, rng) -> dict:
    """Entry 0 (j) and entry 2 (i) share broker X at the same score; j loses
    its other broker Y to entry 1's higher score, so j is no candidate and
    the reference selects i. A folded (score, ~index) max would select
    neither."""
    x, y, z, w = 0, 4, 8, 12  # four hosts
    used = set()
    pj, sj = _move_from(a, x, {y}, rng, used)
    pk, sk = _move_from(a, w, {y}, rng, used)
    pi, si = _move_from(a, z, {x}, rng, used)
    wave = _wave([(pj, 0, sj, y, 1.0), (pk, 0, sk, y, 2.0), (pi, 0, si, x, 1.0)])
    wave["occurs"] = lambda sel: (not sel[0]) and bool(sel[1]) and bool(sel[2])
    return wave


def signed_zeros(a, host, rng) -> dict:
    """Scores of -0.0 and +0.0 that share brokers (B, E) and a destination
    host (H and J): they tie, so the lowest index wins each group, even where
    it holds -0.0."""
    used = set()
    entries = []
    # (src, dst, score): B = 4, E = 10, H = 16 and J = 17 on one host
    for src, dst, sc in ((0, 4, -0.0), (7, 4, 0.0), (9, 10, 0.0), (13, 10, -0.0),
                         (19, 16, -0.0), (22, 17, 0.0)):
        p, s = _move_from(a, src, {dst}, rng, used)
        entries.append((p, 0, s, dst, sc))
    assert host[16] == host[17]
    wave = _wave(entries)
    wave["occurs"] = lambda sel: (sel[0] and not sel[1] and sel[2] and not sel[3]
                                  and sel[4] and not sel[5])
    return wave


def _sub_in_order(x, ds):
    for d in ds:
        x = np.float32(np.float32(x) - np.float32(d))
    return x


#: shared_source_hosts' source brokers in entry order (hosts 0 and 1
#: interleaved) and each one's destination (six other hosts)
SOURCES = (2, 3, 0, 5, 1, 4)
DESTINATIONS = {0: 6, 1: 9, 2: 12, 3: 15, 4: 18, 5: 21}


def _source_moves(a) -> dict:
    """source broker -> (p, slot) of shared_source_hosts' moves: partitions
    with no replica on the other source host or on the destination."""
    rng = np.random.default_rng(3)
    used, moves = set(), {}
    for b in SOURCES:
        other = {x for x in SOURCES if x // BROKERS_PER_HOST != b // BROKERS_PER_HOST}
        moves[b] = _move_from(a, b, {DESTINATIONS[b]} | other, rng, used)
    return moves


def _order_sensitive(x, ds) -> bool:
    """Whether every other order of subtracting `ds` from `x` in float32
    gives other bits than their own order."""
    want = _sub_in_order(x, ds)
    return all(_sub_in_order(x, perm) != want
               for perm in itertools.permutations(ds) if list(perm) != list(ds))


def _move_cpu(part_load, p, s):
    return part_load[p, CPU_LEADER if s == 0 else CPU_FOLLOWER]


def _plant_order_sensitive_loads(arrays: dict) -> None:
    """Set the CPU loads of shared_source_hosts' moved replicas, host by
    host, to fractions of their host's load until every other order of
    that host's three subtractions gives other bits (the host loads as K1
    sums them). A host's moved partitions have no replica on the other
    source host, so planting one host leaves the other's load as it was."""
    from cruise_control_torch.analyzer.context import dims_of
    from cruise_control_torch.kernels.segment_aggregates import segment_aggregates_plain
    from cruise_control_torch.models.flat_model import from_numpy

    moves = _source_moves(arrays["assignment"])
    d = dims_of(from_numpy(arrays))
    rng = np.random.default_rng(4)

    def host_cpu():
        t = from_numpy(arrays)
        return segment_aggregates_plain(
            t.assignment, t.part_load, t.topic_id, t.broker_rack, t.broker_host, d.num_brokers,
            d.num_racks, d.num_hosts, d.num_topics)[-1].numpy()

    pl = arrays["part_load"]
    for h in (0, 1):
        mine = [moves[b] for b in SOURCES if b // BROKERS_PER_HOST == h]
        for _ in range(1000):
            x = host_cpu()[h]
            for p, s in mine:
                pl[p, CPU_LEADER if s == 0 else CPU_FOLLOWER] = np.float32(
                    x * 10 ** rng.uniform(-0.6, -0.48))
            if _order_sensitive(host_cpu()[h], [_move_cpu(pl, p, s) for p, s in mine]):
                break
        else:
            raise AssertionError(f"no CPU loads tell host {h}'s orders apart")


def shared_source_hosts(a, part_load, host_cpu) -> dict:
    """Six moves, three from host 0's brokers and three from host 1's, to
    six other hosts, interleaved in entry order: all six are selected, and
    the moved replicas' CPU loads (planted by cluster_arrays) make every
    other order of each host's three subtractions give other float32 bits."""
    moves = _source_moves(a)
    for h in (0, 1):
        ds = [_move_cpu(part_load, *moves[b]) for b in SOURCES if b // BROKERS_PER_HOST == h]
        assert _order_sensitive(host_cpu[h], ds), h
    wave = _wave([(moves[b][0], 0, moves[b][1], DESTINATIONS[b], 1.0) for b in SOURCES])
    wave["occurs"] = lambda sel: bool(sel.all())
    return wave


def relays_e_is_b(a, rng) -> dict:
    """Leadership relays b -> d (leg 1 promotes d in a partition b leads) and
    d -> e (leg 2 promotes e in a partition d leads), three brokers claimed;
    most with e == b (leg 2 hands a leadership back to b), some with e != b;
    twelve relays, each through its own d, with integer scores, so relays
    tie and conflict over b and e."""
    entries = []
    leaders = a[:, 0]
    for p2 in rng.permutation(a.shape[0]):
        d = leaders[p2]
        for s2 in range(1, a.shape[1]):
            e = a[p2, s2]
            if d < 0 or e < 0 or any(x[3] == d for x in entries):
                continue
            # leg 1: a partition led by some b with d as a follower
            firsts = [(p1, s1) for p1, s1 in np.argwhere(a[:, 1:] == d) if p1 != p2
                      and leaders[p1] >= 0 and (leaders[p1] == e) == (len(entries) % 3 != 2)]
            if not firsts:
                continue
            p1, s1 = firsts[rng.integers(0, len(firsts))]
            entries.append((int(p1), 1, int(s1) + 1, int(d), float(rng.integers(0, 3)),
                            int(p2), 1, s2, int(e)))
            break
        if len(entries) == 12:
            break
    wave = _wave(entries, brokers3=True)
    b = np.asarray([leaders[e[0]] for e in entries])
    e_arr = np.asarray([e[8] for e in entries])
    wave["occurs"] = lambda sel: bool((sel & (e_arr == b)).any()) and bool((sel & (e_arr != b)).any())
    return wave


def bulk_width(a, rng, num_brokers: int = NUM_BROKERS) -> dict:
    """One entry per broker, as the bulk planner's waves hold: broker b
    moves one of its replicas to a random broker, or (as leader) promotes a
    follower; integer scores with some -inf, flagged where finite."""
    entries = []
    for b in range(num_brokers):
        held = np.argwhere(a == b)
        led = held[held[:, 1] == 0]
        if len(led) and rng.random() < 0.3:
            p = int(led[rng.integers(0, len(led))][0])
            s = int(rng.integers(1, a.shape[1]))
            entries.append((p, 1, s, int(a[p, s]), float(rng.integers(0, 4))))
        else:
            p, s = held[rng.integers(0, len(held))] if len(held) else (0, 0)
            d = int((b + rng.integers(1, num_brokers)) % num_brokers)
            entries.append((int(p), 0, int(s), d, float(rng.integers(0, 4))))
    wave = _wave(entries)
    wave["score"][rng.random(num_brokers) < 0.15] = -np.inf
    wave["ok"] = np.isfinite(wave["score"])
    kinds = wave["legs"][0][1]
    wave["occurs"] = lambda sel: int(sel.sum()) >= 3 and bool((sel & (kinds == 1)).any())
    return wave


def flag_valid(wave: dict, a) -> dict:
    """Unflag the entries whose actions are not valid (an empty slot, src ==
    dst), as the scoring kernels never give those a finite score."""
    ok = wave["ok"].copy()
    for p, kind, slot, dst in wave["legs"]:
        src = np.where(kind == 0, a[p, slot], a[p, 0])
        ok &= (src >= 0) & (dst >= 0) & (src != dst)
    out = dict(wave)
    out["ok"] = ok
    return out


def cases(arrays: dict, host_cpu) -> dict:
    """Every crafted case by name, on `cluster_arrays()` with the initial
    host CPU loads `host_cpu` (f32[H])."""
    a, pl, host = arrays["assignment"], arrays["part_load"], arrays["broker_host"]
    rng = np.random.default_rng(8)
    out = {"not_a_candidate": not_a_candidate(a, rng), "signed_zeros": signed_zeros(a, host, rng),
           "shared_source_hosts": shared_source_hosts(a, pl, np.asarray(host_cpu)),
           "relays_e_is_b": relays_e_is_b(a, rng), "bulk_width": bulk_width(a, rng)}
    return {k: flag_valid(v, a) for k, v in out.items()}
