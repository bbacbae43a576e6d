"""Serving-side elasticity of the port (agent-set versions)."""
