"""Command-line tools of the port: ``cabextract``, ``cabinfo``, ``cabsplit``
and ``wince`` (``python -m libmspack_tpu_torch.cli.<tool>``), copies of
``libmspack_tpu/cli/``."""
