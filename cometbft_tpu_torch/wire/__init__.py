"""Wire encodings the port's sidecar speaks (the reference's, byte for byte)."""
