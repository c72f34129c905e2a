from .roofline import HW, collective_bytes_from_hlo, roofline_terms
__all__ = ["HW", "collective_bytes_from_hlo", "roofline_terms"]
