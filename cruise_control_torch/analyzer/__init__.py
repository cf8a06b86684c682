"""Analyzer: goal kernels and the batched-greedy optimizer, in PyTorch.

Submodules are imported directly (`analyzer.optimizer`, `analyzer.context`,
...); this package module stays empty so the kernel modules can import
`analyzer.actions` without pulling the optimizer in.
"""
