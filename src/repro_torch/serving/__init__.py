"""Workload generators, the real serving engine (`engine.AgentEngine`) and
the analytic serving engine of the port."""
