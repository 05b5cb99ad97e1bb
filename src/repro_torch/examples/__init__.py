"""Runnable examples of the port, counterparts of the repo's ``examples/``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.brain_registration [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.incompressible_registration [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.multilevel_registration [--device cpu]

Each runs on the card unless ``--device cpu`` is given; ``--n`` sets the
grid size.
"""
