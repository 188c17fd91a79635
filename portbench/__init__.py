"""The port's benchmark: ``python3 -m portbench.run`` (see ``run.py``)."""
