"""The paper's small models, batched over a leading client axis
(``small``), and the transformer zoo: ``layers``, ``attention``, ``ssm``
and their assembly ``model``."""
