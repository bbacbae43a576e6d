"""Workload generators and the analytic serving engine of the port."""
