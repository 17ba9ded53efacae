"""The harness: spec loading, inputs, loops, tracing and the check."""
