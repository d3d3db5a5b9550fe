"""Models of the port: the serving path of the ``attn`` and ``moe`` block
kinds, counterparts of ``repro.models``."""
