"""crowdnav_tpu_torch — the PyTorch/CUDA port of ``crowdnav_tpu``.

Greedy TD3 evaluation of the perceived-risk crowd-navigation env on an
NVIDIA GPU, in PyTorch, with hand-written CUDA kernels for the lidar
raycast and the tracker -> collision probability -> top-K chain
(``kernels/``). Subpackages mirror the JAX package's: ``envs``, ``ops``,
``models``, ``agents``, ``parallel``, ``utils``, ``drivers``. Entry points
run on ``device="cuda"`` unless the caller passes ``"cpu"``.
"""
