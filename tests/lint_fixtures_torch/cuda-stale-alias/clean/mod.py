"""Clean fixture: copy before the in-place write, or re-read the field."""


def apply_wave(static, agg, p, kind, slot, dst, score, ok, tag):
    agg.broker_load.index_add_(0, dst, score)


def good(static, agg, p, kind, slot, dst, score, ok):
    before = agg.broker_load.clone()
    dev = agg.broker_load  # rebound below before any read
    apply_wave(static, agg, p, kind, slot, dst, score, ok, 0)
    dev = agg.broker_load
    return agg.broker_load.sum() - before.sum(), dev.device
