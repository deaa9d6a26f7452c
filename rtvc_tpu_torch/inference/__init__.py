"""Public inference API: ``encoder``, ``synthesizer``, ``vocoder``."""
