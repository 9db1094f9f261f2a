"""Serving frontends (host-only): persisted-table polling, interpolation
and ``ServerSet`` routing over replicas."""
