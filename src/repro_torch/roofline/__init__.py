"""The card's roofline constants (``hw``)."""
