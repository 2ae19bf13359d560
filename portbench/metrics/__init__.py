"""The metrics' readers (`<metric>.py`, each a `read(run)` that returns a
number or None where it finds nothing to read), the functions they share
(`common.py`), the circuits' work counts (`workcount.py`) and the card's
fixed peak (`peak.py`)."""
