"""The JAX package's demos through the port: ``hello_world``, ``chain``,
``inference``, ``billiards`` and ``sharded_inference``.  Run one from the
repository root with ``python -m lcp_physics_tpu_torch.demos.<name>``; each
is headless and on the card unless ``--display`` or ``--device cpu`` is
given."""
