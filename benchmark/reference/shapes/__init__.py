"""The reference's body shapes, one module a shape, found by the name a
configuration's ``shape`` gives (``world.shape``).  A module holds
``params(config, dtype, device)``, the world's per-body parameters, and
``contacts(world, p, v, dt)``, its narrowphase into the padded contact
buffer that ``world.blocks`` assembles, and where the shape's worlds are
jointed ``equality(world, p)``, their equality rows A (B, q, 3N) and b
(B, q) (``reference/joints.py`` builds them from a configuration's
``joints``)."""
