"""Traffic drivers: a mix file's ``driver`` names one of these modules.

Each has ``setup(run)``, ``window(run)``, ``free(run)`` and ``check(run)``
(returning ``{name: {"value": v, "limit": l}}``)."""
