"""The harness's own code: discovery, what the model families share, the
proxy between the scheduler and the engine, the output check and the
trace reduction."""
