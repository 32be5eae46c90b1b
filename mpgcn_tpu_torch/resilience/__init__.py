"""The self-healing trainer's pieces (step sentinels, rollback, the hang
watchdog) and the fault-injection plan (faults.py)."""
