"""Runtime pieces of the port: the serving-step builders, the training
step (``train_lib``), the step watchdog (``fault``) and weight-only int8
serving weights (``quantized``)."""
