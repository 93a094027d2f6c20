"""Model building blocks (``nn.Module``s and their functional cores)."""
