"""Input builders, one module per archive format, found by the ``format``
of a configuration: ``build(config, traffic, seed, threads)`` returns the
cell's pool of ``gen.Item``."""
