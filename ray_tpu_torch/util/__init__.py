"""Host-side utilities of the port (storage URIs)."""
