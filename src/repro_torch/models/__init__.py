"""Models of the port: the serving path of every block kind (``attn``,
``moe``, ``mamba2``, ``mlstm``, ``slstm``, ``shared_attn``) and both
frontend stubs, counterparts of ``repro.models``."""
