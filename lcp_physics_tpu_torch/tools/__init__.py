"""Tools that drive the port at full size on the card: the f32
physics-quality guard (``validate_f32``), the big single worlds
(``bigworld``), the benchmark (``bench``) and its measuring tools
(``iter_bench``, ``roofline``, ``bwd_roofline``, ``asm_vjp_probe``), and
the parity harness against the reference engine (``parity``).  Each runs
as ``python -m lcp_physics_tpu_torch.tools.<name>`` and defaults to the
card."""
