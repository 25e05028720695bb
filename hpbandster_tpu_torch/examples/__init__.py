"""The example ladder on the PyTorch package (ported from ``examples/``).

Twelve scripts with the reference's file names and arguments, plus
``--device`` (``cuda`` by default; ``cpu`` on request, and nothing else
falls back: without a card and without ``--device cpu`` each raises).
Run one as a module from the repo root::

    python -m hpbandster_tpu_torch.examples.example_8_large_sweep --device cpu

or call its ``main(argv)``, which returns the run's ``Result`` (or the
dict it prints). Each prints the lines ``tests/test_examples.py`` asserts
for its counterpart.
"""
