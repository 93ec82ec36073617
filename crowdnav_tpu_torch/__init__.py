"""crowdnav_tpu_torch — the PyTorch/CUDA port of ``crowdnav_tpu``.

Training and greedy evaluation of TD3 and DDPG on the perceived-risk
crowd-navigation env, and of SAC and DQN on the simple env, on an NVIDIA
GPU, in PyTorch, with hand-written CUDA kernels for the lidar raycast and
the tracker -> collision probability -> top-K chain (``kernels/``). Entry
points run on ``device="cuda"`` unless the caller passes ``"cpu"``.

Subpackages mirror the JAX package's (bottom-up):

- ``ops``       geometry / lidar raycast / perceived-risk pipeline
- ``kernels``   the CUDA kernels, their build and their bindings
- ``envs``      world model, batched env engine (perceived-risk + simple)
- ``models``    network definitions (actors, critics, Q-MLPs)
- ``agents``    TD3, DDPG, SAC, DQN, tabular Q/SARSA + the replay ring
- ``parallel``  the trainer, the rank mesh, sharded training
- ``utils``     config I/O, CSV episode logs, checkpointing, numerics
- ``drivers``   the command lines: train, evaluate, tabular, deployment
- ``native``    the C++ host simulator (single env and OpenMP batch)
- ``parity``    NumPy reference-faithful single-env port (test oracle)
"""
