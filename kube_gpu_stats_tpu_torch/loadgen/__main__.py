from .burn import main

raise SystemExit(main())
