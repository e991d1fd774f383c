"""Plain references that judge each entry's answers: ``<entry>.py`` holds
``check(config, traffic, samples, seed) -> (checks, per_request)``.  They
import nothing of the program."""
