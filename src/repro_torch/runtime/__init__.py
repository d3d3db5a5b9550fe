"""Runtime pieces of the port: the serving-step builders."""
