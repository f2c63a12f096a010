"""Target hardware constants (one NVIDIA H100 SXM) for the roofline
model.

The port's counterpart of the JAX package's ``roofline/hw.py``, which
holds a TPU v5e's.  From NVIDIA's H100 data sheet (SXM part, dense
rates without sparsity, at the 700 W power limit): 989 TFLOP/s of bf16
on the tensor cores, 67 TFLOP/s of float32 outside them, 80 GB of HBM3
at 3.35 TB/s, and NVLink 4 at 900 GB/s in total over 18 links.

The collective term divides a chip's collective bytes by one rate a
chip.  The TPU's formula takes one ICI link a chip; a card's NVLink
links all reach the NVSwitch fabric at once, so the rate here is the
whole card's in one direction: 900 GB/s over both directions is
450 GB/s each way (18 links of 25 GB/s each way).
"""

PEAK_FLOPS_BF16 = 989e12     # per card, FLOP/s (tensor cores, dense)
PEAK_FLOPS_F32 = 67e12       # per card, FLOP/s (outside the tensor cores)
HBM_BW = 3.35e12             # per card, B/s

NVLINK_LINKS = 18
NVLINK_BW_TOTAL = 900e9      # per card, B/s, both directions, all links
# the per-chip rate the collective term divides by (see the docstring)
ICI_LINK_BW = NVLINK_BW_TOTAL / 2

# per-device HBM capacity (fit check)
HBM_BYTES = 80 * 10 ** 9
