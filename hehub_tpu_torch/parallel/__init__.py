"""Multi-rank and multi-device execution (port of hehub_tpu/parallel/*):
`mesh` (the (batch, limb) mesh over torch.distributed, the sharded CKKS
key switch and rescale, the rank launcher), `ntt_sharded` (one
polynomial's transform across ranks), `pipeline` (staged deep circuits on
CUDA streams and devices)."""
