"""The LM scaffold's models (the port of ``repro.models``): configs,
layers, MoE, Mamba, RWKV6 and the four model families."""
