"""Host-side utilities: geometry and the PNG codec."""
