"""Host utilities of the port (experiment bootstrap and metric streams)."""
