"""The harness: the cell's files found by name, the generator of its
inputs, its loop, the window, the trace's reduction and the check."""
