"""Foundation utilities: GSM constants and frame-clock arithmetic."""
