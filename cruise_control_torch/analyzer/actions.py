"""Balancing actions as broadcast-friendly tensor batches.

A batch of candidate actions is a struct of tensors with mutually
broadcastable shapes, as in the JAX package: a [V, K, C] drain grid of
(partition, slot, destination) moves or a [P, R-1] grid of promotions is
scored as one batch. Action kinds mirror cc/analyzer/ActionType.java:24.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cruise_control_torch.common.resources import PartMetric, Resource
from cruise_control_torch.models.flat_model import follower_contribution, leader_contribution

KIND_MOVE = 0
KIND_LEADERSHIP = 1

#: Score bonus that makes dead-broker evacuation dominate any balance score
#: (GoalUtils.ensureNoReplicaOnDeadBrokers semantics).
DEAD_EVACUATION_BONUS = 1.0e6


class ActionBatch(NamedTuple):
    """A batch of candidate actions; all fields broadcast to a common shape.

    kind  : i32[...]  KIND_MOVE or KIND_LEADERSHIP
    p     : i32[...]  partition index
    slot  : i32[...]  replica slot being moved (move) or promoted (leadership)
    src   : i32[...]  broker losing load
    dst   : i32[...]  broker gaining load
    valid : bool[...] structurally valid candidate
    dload : f32[..., 4] per-Resource load transferred src -> dst
    drep  : i32[...]  replica-count change at dst (+1 for moves)
    dleader : i32[...] leader-count change at dst
    dpnw  : f32[...]  potential-NW_OUT transferred (moves only)
    dleader_nw_in : f32[...] leader bytes-in transferred
    """

    kind: torch.Tensor
    p: torch.Tensor
    slot: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    valid: torch.Tensor
    dload: torch.Tensor
    drep: torch.Tensor
    dleader: torch.Tensor
    dpnw: torch.Tensor
    dleader_nw_in: torch.Tensor


def _leader_vec(part_load: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """f32[..., 4] load the partitions `p` place on their leader."""
    return leader_contribution(part_load[p.long()])


def _follower_vec(part_load: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return follower_contribution(part_load[p.long()])


def load_total(vec: torch.Tensor) -> torch.Tensor:
    """f32[...]: the sum of a [..., 4] load vector, added in index order (the
    order of XLA:CPU's sum over four terms)."""
    return ((vec[..., 0] + vec[..., 1]) + vec[..., 2]) + vec[..., 3]


def slot_contrib(part_load: torch.Tensor, assignment: torch.Tensor, res: int) -> torch.Tensor:
    """f32[P, R]: per-slot load contribution for one Resource (leader slots
    carry the leader variant, followers the follower variant)."""
    lead = {
        Resource.CPU: part_load[:, PartMetric.CPU_LEADER],
        Resource.NW_IN: part_load[:, PartMetric.NW_IN_LEADER],
        Resource.NW_OUT: part_load[:, PartMetric.NW_OUT_LEADER],
        Resource.DISK: part_load[:, PartMetric.DISK],
    }[Resource(res)]
    foll = {
        Resource.CPU: part_load[:, PartMetric.CPU_FOLLOWER],
        Resource.NW_IN: part_load[:, PartMetric.NW_IN_FOLLOWER],
        Resource.NW_OUT: torch.zeros_like(lead),
        Resource.DISK: part_load[:, PartMetric.DISK],
    }[Resource(res)]
    r = assignment.shape[1]
    is_leader = (torch.arange(r, device=assignment.device) == 0)[None, :]
    return torch.where(is_leader, lead[:, None], foll[:, None])


def make_move_batch(assignment: torch.Tensor, dst_cands: torch.Tensor):
    """(p, kind, slot, dst) index tensors of the [P, R, K] move grid: every
    replica slot toward every destination candidate (the JAX package's
    make_move_batch, :113, as indices for build_selected / K3 / K9). The
    tensors stay at their broadcast shapes, p [P,1,1], slot [1,R,1], dst
    [1,1,K]: nothing is materialized at [P, R, K]. build_selected's extra
    `dst >= 0` check changes nothing: a destination candidate is a broker."""
    p_count, r = assignment.shape
    dev = assignment.device
    p = torch.arange(p_count, dtype=torch.int32, device=dev)[:, None, None]
    slot = torch.arange(r, dtype=torch.int32, device=dev)[None, :, None]
    kind = torch.tensor(KIND_MOVE, dtype=torch.int32, device=dev)
    return p, kind, slot, dst_cands.to(torch.int32)[None, None, :]


def leadership_grid(assignment: torch.Tensor):
    """(p, kind, slot, dst) index tensors of the [P, R-1] promotion grid:
    promote the replica in slot s >= 1 to leader (the JAX package's
    make_leadership_batch, :153, as indices for build_selected / K3). `dst` is
    a strided view of the assignment (no copy). build_selected's extra
    `src != dst` check changes nothing here: a valid model never holds a
    partition twice on one broker (sanity_check)."""
    p_count, r = assignment.shape
    if r < 2:
        raise ValueError("leadership batch requires max replication factor >= 2")
    dev = assignment.device
    p = torch.arange(p_count, dtype=torch.int32, device=dev)[:, None]
    slot = torch.arange(1, r, dtype=torch.int32, device=dev)[None, :]
    kind = torch.tensor(KIND_LEADERSHIP, dtype=torch.int32, device=dev)
    return p, kind, slot, assignment[:, 1:]


def build_selected(part_load, assignment, p, kind, slot, dst) -> ActionBatch:
    """Materialize concrete actions from (partition, kind, slot, dst) picks;
    the four index tensors broadcast to a common shape."""
    dev = assignment.device
    kind = torch.as_tensor(kind, dtype=torch.int32, device=dev)
    is_move = kind == KIND_MOVE
    pl_idx, slot_l = p.long(), slot.long()
    src = torch.where(is_move, assignment[pl_idx, slot_l], assignment[pl_idx, 0])
    pl = part_load[pl_idx]
    lead = _leader_vec(part_load, p)
    foll = _follower_vec(part_load, p)
    move_load = torch.where((slot == 0)[..., None], lead, foll)
    dload = torch.where(is_move[..., None], move_load, lead - foll)
    leader_transfer = (~is_move) | (slot == 0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return ActionBatch(
        kind=kind,
        p=p,
        slot=slot,
        src=src,
        dst=dst,
        valid=(src >= 0) & (dst >= 0) & (src != dst),
        dload=dload,
        drep=is_move.to(torch.int32),
        dleader=leader_transfer.to(torch.int32),
        dpnw=torch.where(is_move, pl[..., PartMetric.NW_OUT_LEADER], zero),
        dleader_nw_in=torch.where(leader_transfer, pl[..., PartMetric.NW_IN_LEADER], zero),
    )


def _clamped(i, n: int, dev) -> torch.Tensor:
    """An index tensor read as JAX's gather reads it: a negative index counts
    from the end once, then the index is clamped to [0, n - 1] (torch would
    raise where JAX clamps)."""
    i = torch.as_tensor(i, device=dev).long()
    return torch.clamp(torch.where(i < 0, i + n, i), 0, max(n - 1, 0))


def gather_actions(batch: ActionBatch, *idx) -> ActionBatch:
    """Pick concrete actions out of a broadcast grid by index arrays (the JAX
    package's gather_actions, actions.py:219).

    `idx` has one index array per grid axis; each field is broadcast (a
    view) and then gathered, so the full grid is never materialized. Indices
    out of range are clamped as JAX clamps them."""
    grid = (batch.kind, batch.p, batch.slot, batch.src, batch.dst, batch.valid)
    shape = torch.broadcast_shapes(*(torch.as_tensor(f).shape for f in grid))
    dev = batch.p.device
    # cclint: disable=cuda-python-loop -- one index tensor a grid axis (2 or 3 of them), not a loop over a model axis
    at = tuple(_clamped(i, n, dev) for i, n in zip(idx, shape))

    def pick(field):
        return torch.as_tensor(field, device=dev).broadcast_to(shape)[at]

    def pick_vec(field):  # trailing per-Resource axis
        return field.broadcast_to(shape + (field.shape[-1],))[at]

    return ActionBatch(
        kind=pick(batch.kind),
        p=pick(batch.p),
        slot=pick(batch.slot),
        src=pick(batch.src),
        dst=pick(batch.dst),
        valid=pick(batch.valid),
        dload=pick_vec(batch.dload),
        drep=pick(batch.drep),
        dleader=pick(batch.dleader),
        dpnw=pick(batch.dpnw),
        dleader_nw_in=pick(batch.dleader_nw_in),
    )


@dataclasses.dataclass(frozen=True)
class BalancingAction:
    """Host-side rendering of one applied action, the analog of
    cc/analyzer/BalancingAction.java:17 (for logs, REST responses, tests)."""

    partition: int
    slot: int
    source_broker: int
    destination_broker: int
    kind: int  # KIND_MOVE | KIND_LEADERSHIP

    @property
    def action_type(self) -> str:
        return (
            "INTER_BROKER_REPLICA_MOVEMENT" if self.kind == KIND_MOVE else "LEADERSHIP_MOVEMENT"
        )
