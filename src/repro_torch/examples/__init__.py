"""End-to-end examples of the port's real data planes: ``serve_moe`` (two
dense-cache engines under the Gimbal loop, experts migrating live) and
``serve_moe_paged`` (two paged engines through ``serve_real_cluster``, with
its ``--shared-prefix`` and ``--chaos`` modes). ``launch/serve.py --real``
runs them. ``placement_demo`` walks through Algorithm 2's expert placement
on a synthetic routing window (numpy only, no model)."""
