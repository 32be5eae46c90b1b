"""The self-healing trainer's pieces (step sentinels, rollback, the hang
watchdog, the replicas' digest check) and the fault-injection plan
(faults.py)."""
