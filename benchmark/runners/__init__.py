"""Runners of the traffic mixes: a traffic file's ``runner`` names one of
these modules, whose ``run(run)`` makes the set-up, the window, the traced
calls and the comparison of one run (``benchmark.harness.Run``)."""
