"""The JAX package's example scripts (``examples/*.py``), one module each
with the same name, on the port. Each has ``main(device=None)`` (the card
by default) and prints what its JAX twin prints:

    python -m jwave_tpu_torch.examples.cwt_example [--device cpu]

``sharded_example`` runs on every rank of a process group
(``torchrun --nproc-per-node 4 -m jwave_tpu_torch.examples.sharded_example
--device cpu``) or, with none, in a one-rank world.
"""
