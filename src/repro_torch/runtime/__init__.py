"""Runtime pieces of the port: the serving-step builders, the training
step (``train_lib``), the step watchdog (``fault``), weight-only int8
serving weights (``quantized``), the mesh's specs and collectives
(``sharding``) and the GPipe pipeline (``pipeline_parallel``)."""
