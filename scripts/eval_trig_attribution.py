"""Which change moved the card's evaluation: the port's evaluation driver
(``chip_smoke.py``'s evaluate phase: ``final_full``'s actor on suite
``train``, 1,024 envs x 500 steps) run twice in one process on one card,
first with PyTorch's CUDA ``cos``/``sin``/``atan2`` in place of the
C-library trig kernel (``kernels/csrc/libm_trig.cu``), then with the
kernel. Prints one JSON line per run. Needs a CUDA device.

    python scripts/eval_trig_attribution.py
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch

    import chip_smoke as cs
    from crowdnav_tpu_torch.utils import numerics as nm
    if not torch.cuda.is_available():
        raise SystemExit("eval_trig_attribution: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    libm_sincos, libm_atan2 = nm.sincos, nm.atan2

    def torch_sincos(x, cosine):
        if not x.is_cuda:
            return libm_sincos(x, cosine)
        return torch.cos(x) if cosine else torch.sin(x)

    def torch_atan2(y, x):
        return torch.atan2(y, x) if y.is_cuda else libm_atan2(y, x)

    read = cs._read_launches
    for name, sincos, atan2 in (("pytorch_trig", torch_sincos, torch_atan2),
                                ("libm_trig", libm_sincos, libm_atan2)):
        nm.sincos, nm.atan2 = sincos, atan2
        if name == "pytorch_trig":   # the trig kernel is not launched
            cs._read_launches = lambda: {
                k: v for k, v in read().items()
                if k in ("raycast", "track_cp_topk")}
        else:
            cs._read_launches = read
        print(json.dumps({"trig": name}), flush=True)
        cs.phase_evaluate(torch)


if __name__ == "__main__":
    main()
