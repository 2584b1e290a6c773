"""Launchers of the LM scaffold (the port of ``repro.launch``): serving
and single-device training."""
