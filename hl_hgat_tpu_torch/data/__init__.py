"""Sample generators."""
