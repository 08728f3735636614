"""LTFB tournaments of the port, host backend (``repro.core``)."""
