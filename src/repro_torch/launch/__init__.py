"""Command-line entry points: ``serve`` (the simulated cluster, a registered
scenario, or the real data plane with ``--real``) and ``stress`` (registered
scenarios at 10^5-10^6 simulated requests)."""
