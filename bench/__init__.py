"""The port's benchmark (``BENCHMARK.json``): ``python3 -m bench.run``.
Measures ``src/repro_torch`` only; nothing here imports JAX or the JAX
package."""
