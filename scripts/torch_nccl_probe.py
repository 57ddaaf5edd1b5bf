#!/usr/bin/env python3
"""Whether NCCL takes two ranks on one card: starts a World of two ranks
over NCCL, both on cuda:0 (hehub_tpu_torch.parallel.mesh), and runs one
all_reduce in them; prints what NCCL answered, then the card's name and
power limit. Needs an NVIDIA card.

    python3 scripts/torch_nccl_probe.py
"""

import os
import subprocess
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.getcwd())

from hehub_tpu_torch.parallel import mesh as pmesh  # noqa: E402


def _all_reduce() -> float:
    t = torch.ones(4, device=pmesh.rank_device())
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_nccl_probe: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}, {torch.cuda.device_count()} card(s)")
    try:
        with pmesh.World(2, "nccl", [torch.device("cuda", 0)] * 2, timeout=60) as world:
            out = world.run(_all_reduce)
        print(f"NCCL took two ranks on cuda:0: all_reduce gave {out}")
    except (RuntimeError, TimeoutError) as err:
        lines = [ln for ln in str(err).splitlines() if ln.strip()]
        print("NCCL refused two ranks on cuda:0; the rank's last lines:")
        for ln in lines[-6:]:
            print(f"    {ln}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
