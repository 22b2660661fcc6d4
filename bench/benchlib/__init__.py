"""The benchmark harness: loading cells by name, making inputs from the
seed, the frozen counts, reading traces, and running one cell."""
