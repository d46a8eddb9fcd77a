"""The plain reference that decides ``correct``: worlds of rigid bodies,
their contact LCP and its implicit gradient in plain PyTorch.

Nothing here imports the program under test or JAX.  ``world`` builds
contacts, the LCP blocks and one semi-implicit Euler step from a state,
with the equality rows of a jointed world's joints (``joints``);
``lcp`` solves the mixed LCP by the same Mehrotra predictor-corrector
(same start, stopping and stall rules) on a dense Schur complement with
the row-pivoted library LU, with the implicit KKT backward; ``train``
rolls out, scores and takes Adam steps for the parameter-inference cell.
"""
