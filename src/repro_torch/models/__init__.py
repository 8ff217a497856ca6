"""Model code of the port: layers, attention, transformer stack."""
