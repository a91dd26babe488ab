"""Entry kinds: each module drives one path of the program (``Entry``)
and holds it to the reference."""
