"""The self-healing trainer's pieces: step sentinels, rollback, the hang
watchdog."""
