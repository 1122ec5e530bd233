"""The benchmark's harness: cells, set-up, the measured window, the trace
reading and the result line (``run.py`` is the command)."""
