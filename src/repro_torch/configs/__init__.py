"""Cluster and router configurations of the port."""
