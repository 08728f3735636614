"""The in-memory sample store of the port (``repro.datastore``)."""
