# cclint: kernel-module
"""Flagging fixture: means over the padded axis length."""


def bad(static, total, dims):
    b_count = dims.num_brokers
    per_broker = total / b_count
    per_part = total / dims.num_partitions
    return per_broker + per_part
