"""The scenario engine (counterpart of mpgcn_tpu/scenarios/):
``profiles`` (named city-modality workloads with declared statistics,
their seeded generators and spools), ``dynamics`` (regime shifts,
modality-mix drift, event shocks and the poison payloads of the fault
arms), ``transfer`` (donor selection and the steps-to-promote A/B of a
warm start across cities) and ``federation`` (one continual-learning
daemon per profile into one fleet registry, and the cross-tenant
report). ``scenario list|gen|run`` is scenarios/cli.py. Import-empty:
only ``transfer_ab`` and the federation's daemons import torch."""
