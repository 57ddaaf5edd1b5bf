"""The JAX package's demos (examples/*.py) as port twins, each with the
reference's parameters and its own check, run on the card by
`python -m hehub_tpu_torch.examples.<name>` and on the CPU by
`main(..., device="cpu")`:

  * ckks_example: the Basel series at n=4096, one squaring and the slot
    folds, within 5e-2 of the sum;
  * bgv_example: (a + b)·c mod t at n=4096, exact;
  * tfhe_example: the bootstrapped NAND truth table.
"""
