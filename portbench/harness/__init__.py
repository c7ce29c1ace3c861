"""The benchmark's own machinery: the cell's files, the result line, the
device checks, the trace reduction, the work counts and the inputs. It
imports neither JAX nor the program at module level; the drivers import
the program inside their functions."""
