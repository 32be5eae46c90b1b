"""Quantized payloads (int8 codes with f32 scales)."""
