"""The harness's own code: discovery, weights, the proxy between the
scheduler and the engine, the output check and the trace reduction."""
