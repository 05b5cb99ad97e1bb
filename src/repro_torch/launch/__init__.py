"""Entry points that serve registrations (counterpart of ``repro/launch``):
``reg_serve``, the cohort registration server."""
