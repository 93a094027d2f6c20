"""Host-side (NumPy) complex construction and the dense-block batch layout."""
