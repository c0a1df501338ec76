"""Hardware constants of the port's card, one NVIDIA H100 SXM, from NVIDIA's
H100 Tensor Core GPU datasheet (SXM part, dense rates without sparsity, at
the full 700 W power limit):

  PEAK_FLOPS_BF16  989 TFLOP/s, bf16 on the tensor cores
  HBM_BW           3.35 TB/s of HBM3
  NVLINK_BW        900 GB/s of NVLink to the other cards of the host, all
                   to all (450 GB/s each way)

The reference's mesh builders (``make_production_mesh``,
``make_smoke_mesh``) wait for the port's ``distributed/`` package: the port
runs on one card until then.
"""

PEAK_FLOPS_BF16 = 989e12  # per card, dense
HBM_BW = 3.35e12  # bytes/s per card
NVLINK_BW = 900e9  # bytes/s per card, aggregate over its links
