"""Model families and reference presets."""
