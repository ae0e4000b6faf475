"""Command-line entry points of the port, one per script of the JAX
package's ``examples/`` under the same file name:

    python -m d2slam_tpu_torch.examples.<name> [--cpu] ...

Each module has ``main(argv=None) -> int``, which tests and
``chip_smoke.py`` call in-process; its last line of output is one JSON
object with the run's summary. Every entry point runs on the CUDA card
unless ``--cpu`` is given.
"""
