"""Flagging fixture: aliases of the aggregates read after in-place writes."""


def apply_wave(static, agg, p, kind, slot, dst, score, ok, tag):
    agg.broker_load.index_add_(0, dst, score)


def bad(static, agg, p, kind, slot, dst, score, ok, idx, one):
    load = agg.broker_load
    apply_wave(static, agg, p, kind, slot, dst, score, ok, 0)
    gain = load.sum()  # holds the NEW loads, not the old ones
    counts = agg.replica_count
    agg.replica_count.index_add_(0, idx, one)
    return gain, counts.sum()
