"""Host utilities: audio IO, loggers and the config printer."""
