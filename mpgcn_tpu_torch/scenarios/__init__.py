"""Scenario payloads the port's fault arms use (counterpart of
mpgcn_tpu/scenarios/)."""
