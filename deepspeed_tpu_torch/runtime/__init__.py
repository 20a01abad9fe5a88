"""The training runtime of the port (config, schedules, data, engine)."""
