from yoloq.cli.main import main

main()
