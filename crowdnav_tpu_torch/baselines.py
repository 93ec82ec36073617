"""Non-learned baseline policies, batched (port of
``crowdnav_tpu/baselines.py``).

``fsm_obstacle_avoider``: the scripted reactive controller of
``turtlebot3_gazebo/src/gazebo_ros_turtlebot3.cpp:111-186``: three beams
(0, 30 and 330 degrees), drive forward while the front is clear, turn right
when the front or the left is blocked, left when the right is blocked, and
keep turning for a fixed number of ticks. The per-robot state is two int32
tensors; the JAX package's ``lax.cond`` between deciding and turning is a
``torch.where`` over the batch.

``goal_seeker``: a proportional heading controller toward the goal.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# the C++ node's constants, the limits scaled to the 0.6 m sensor as the
# JAX package scales them
FSM_LINEAR_VEL = 0.3
FSM_ANGULAR_VEL = 1.5
FRONT_LIMIT = 0.45
SIDE_LIMIT = 0.25

# FSM modes
GET_DIRECTION, DRIVE_FORWARD, RIGHT_TURN, LEFT_TURN = 0, 1, 2, 3


class FsmState(NamedTuple):
    mode: torch.Tensor        # (...) int32
    turn_left: torch.Tensor   # (...) int32 turn ticks left


def fsm_init(batch_shape=(), device="cuda") -> FsmState:
    """Every robot deciding, no turn under way."""
    def z():
        return torch.zeros(batch_shape, dtype=torch.int32, device=device)

    return FsmState(mode=z(), turn_left=z())


def fsm_obstacle_avoider(obs: torch.Tensor, st: FsmState,
                         turn_ticks: int = 6):
    """``(actions (..., 2), next state)`` from observations (..., >= 359)
    whose first 359 entries are the scan, clockwise from the heading (the
    C++ node's counter-clockwise 30 and 330 degree beams are beams 329 and
    30). A robot that is deciding or driving decides anew; a turning one
    counts its ticks down and decides again when they run out."""
    center, left, right = obs[..., 0], obs[..., 329], obs[..., 30]
    i32 = torch.int32
    blocked_front = (center < FRONT_LIMIT) | (left < SIDE_LIMIT)
    blocked_right = right < SIDE_LIMIT
    decided = torch.where(blocked_front, RIGHT_TURN, torch.where(
        blocked_right, LEFT_TURN, DRIVE_FORWARD)).to(i32)
    decided_ticks = torch.where(decided == DRIVE_FORWARD, 0,
                                turn_ticks).to(i32)
    ticks = st.turn_left - 1
    turned = torch.where(ticks <= 0, GET_DIRECTION, st.mode).to(i32)
    deciding = (st.mode == GET_DIRECTION) | (st.mode == DRIVE_FORWARD)
    mode = torch.where(deciding, decided, turned)
    turn_left = torch.where(deciding, decided_ticks,
                            torch.clamp_min(ticks, 0)).to(i32)
    lin = torch.where(mode == DRIVE_FORWARD, FSM_LINEAR_VEL, 0.0)
    ang = torch.where(mode == RIGHT_TURN, -FSM_ANGULAR_VEL, torch.where(
        mode == LEFT_TURN, FSM_ANGULAR_VEL, 0.0))
    # the burger's envelope
    action = torch.stack([torch.clamp_max(lin, 0.22), ang], dim=-1)
    return action, FsmState(mode=mode, turn_left=turn_left)


def goal_seeker(obs: torch.Tensor, max_lin: float = 0.22,
                max_ang: float = 2.0, k_ang: float = 2.0) -> torch.Tensor:
    """(..., 2) actions: turn ``k_ang`` times the heading error to the
    waypoint (observation index 359 in both env layouts), clipped; full
    speed while that error is under 1 rad, else 0.05 m/s."""
    htg = obs[..., 359]
    ang = torch.clamp(k_ang * htg, -max_ang, max_ang)
    lin = torch.where(torch.abs(htg) < 1.0, max_lin, 0.05)
    return torch.stack([lin, ang], dim=-1)
