"""Host utilities: logging and per-stage timers."""
