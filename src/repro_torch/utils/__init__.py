"""Small helpers of the port: timing and device resolution."""
