# cclint: kernel-module
"""Flagging fixture: a Python loop over a model axis (one launch a broker)."""


def bad(loads, num_brokers):
    total = 0.0
    for b in range(num_brokers):
        total += loads[b]
    return total
