"""Executor notification SPI.

Analog of ExecutorNotifier (cc/executor/ExecutorNotifier.java) and the
OPERATION_LOG audit logger (cc/executor/Executor.java): execution lifecycle
events (started / finished / stopped / task state changes) flow to a
pluggable sink. The Executor accepts any callable(event, info); these classes
are the config-instantiable implementations
(`executor.notifier.class`)."""

from __future__ import annotations

import logging
from typing import Dict

OPERATION_LOG = logging.getLogger("cruise_control_torch.operation")


class ExecutorNotifier:
    """SPI: receives (event name, detail dict) per execution event."""

    def __call__(self, event: str, info: Dict) -> None:
        raise NotImplementedError

    def configure(self, configs: Dict) -> None:  # pluggable-component hook
        pass


class LoggingExecutorNotifier(ExecutorNotifier):
    """Default sink: the operation audit log."""

    def __call__(self, event: str, info: Dict) -> None:
        OPERATION_LOG.info("executor %s: %s", event, info)


class NoopExecutorNotifier(ExecutorNotifier):
    def __call__(self, event: str, info: Dict) -> None:
        pass
