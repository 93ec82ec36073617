"""crowdnav_tpu_torch — the PyTorch/CUDA port of ``crowdnav_tpu``.

Training and greedy evaluation of TD3 and DDPG on the perceived-risk
crowd-navigation env, and of SAC and DQN on the simple env, on an NVIDIA
GPU, in PyTorch, with hand-written CUDA kernels for the lidar raycast and
the tracker -> collision probability -> top-K chain (``kernels/``). Subpackages mirror the JAX package's: ``envs``, ``ops``,
``models``, ``agents``, ``parallel``, ``utils``, ``drivers``. Entry points
run on ``device="cuda"`` unless the caller passes ``"cpu"``.
"""
