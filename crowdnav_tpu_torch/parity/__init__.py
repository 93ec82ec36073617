"""Reference-faithful NumPy oracle (kept out of the port's tensor path).

`reference_env.NumpyCrowdEnv` re-implements the sequential semantics of
`environment_stage_1_nobonus.get_state/compute_reward` the way the reference
does it — Python loops over the 359-scan ring, dict-keyed obstacle tracks,
list segmentation — with the documented intended-semantics fixes applied at
the same sites as the port's env. `scenarios` drives the port's
`CrowdEnv` and the oracle with identical physics through the fixed-seed
trajectories of the JAX package's `tests/test_parity.py` and compares
states, rewards and termination step by step (SURVEY.md §7.10).
"""

from crowdnav_tpu_torch.parity.reference_env import NumpyCrowdEnv  # noqa: F401
