"""Model families, one file per family, found by the ``family`` of a
configuration file (``bench/lib/spec.py:family_module``). Each builds its
configurations and counts their work:

* ``model_config(config)``: the port's ``ModelConfig``;
* ``make_params(cfg, seed, device, dtype)``: the weights from the seed;
* ``matmul_params(config)``: the matrix-product parameters one token
  passes;
* ``context_flops(config)``: attention FLOPs of one token per token of
  its context, over all layers;
* ``attention_layers(config)``: how many layers hold K/V;
* ``state_bytes(config)``: the recurrent state one decode row reads and
  writes in a step;
* ``DEVICE_MARKS``: the program's device marks a step of the family
  records (``device_ms.<mark>``).

A new architecture is a configuration file, a family file here and its
reference in ``bench/reference/``."""
