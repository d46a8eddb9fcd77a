"""Tools that drive the port at full size on the card: the f32
physics-quality guard (``validate_f32``) and the big single worlds
(``bigworld``).  Each runs as ``python -m lcp_physics_tpu_torch.tools.<name>``
and defaults to the card."""
